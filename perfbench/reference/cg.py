"""Exact Clebsch-Gordan machinery in the real spherical-harmonic basis: the
benchmark's frozen copy of the port's ``core/cg.py``, so that its plain
reference and its counts of work never read the tables of the program
under test.

``su2_cg`` (Racah's formula on exact rationals), ``real_to_complex_U``,
``real_cg`` (the CG tensor in the real basis), ``real_sh_polys`` (real
spherical harmonics as fitted polynomials, ``Y_00 = 1``), ``wigner_D_real``
and ``u_tensor`` (the symmetrised generalised CG tensors of the symmetric
contraction at correlation 1 to 3, with an orthonormal path basis from an
SVD).  Complex harmonics carry the Condon-Shortley phase; real ones follow
the m<0 -> sin, m>0 -> cos convention.
"""
from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# 1. complex-basis CG via Racah's formula (exact rationals under the sqrt)
# ---------------------------------------------------------------------------


def _fact(n: int) -> int:
    if n < 0:
        raise ValueError("negative factorial")
    return math.factorial(n)


@lru_cache(maxsize=None)
def su2_cg(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int) -> float:
    """<j1 m1 j2 m2 | j3 m3> for integer j (orbital angular momenta)."""
    if m3 != m1 + m2:
        return 0.0
    if not abs(j1 - j2) <= j3 <= j1 + j2:
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0

    pref = Fraction(
        (2 * j3 + 1)
        * _fact(j3 + j1 - j2)
        * _fact(j3 - j1 + j2)
        * _fact(j1 + j2 - j3),
        _fact(j1 + j2 + j3 + 1),
    ) * Fraction(
        _fact(j3 + m3)
        * _fact(j3 - m3)
        * _fact(j1 - m1)
        * _fact(j1 + m1)
        * _fact(j2 - m2)
        * _fact(j2 + m2),
        1,
    )

    ksum = Fraction(0)
    kmin = max(0, -(j3 - j2 + m1), -(j3 - j1 - m2))
    kmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    for k in range(kmin, kmax + 1):
        denom = (
            _fact(k)
            * _fact(j1 + j2 - j3 - k)
            * _fact(j1 - m1 - k)
            * _fact(j2 + m2 - k)
            * _fact(j3 - j2 + m1 + k)
            * _fact(j3 - j1 - m2 + k)
        )
        ksum += Fraction((-1) ** k, denom)

    return math.sqrt(float(pref)) * float(ksum)


# ---------------------------------------------------------------------------
# 2. complex -> real change of basis
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def real_to_complex_U(l: int) -> np.ndarray:
    """U such that Y_real = U @ Y_complex, rows/cols indexed m = -l..l.

    m > 0 : Y^r_{l,m}  = ((-1)^m Y_{l,m} + Y_{l,-m}) / sqrt(2)
    m = 0 : Y^r_{l,0}  = Y_{l,0}
    m < 0 : Y^r_{l,m}  = ((-1)^m Y_{l,|m|} - Y_{l,-|m|}) / (i sqrt(2))
    """
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    s2 = 1.0 / math.sqrt(2.0)

    def idx(m):
        return m + l

    U[idx(0), idx(0)] = 1.0
    for m in range(1, l + 1):
        U[idx(m), idx(m)] = ((-1) ** m) * s2
        U[idx(m), idx(-m)] = s2
        U[idx(-m), idx(m)] = -1j * ((-1) ** m) * s2
        U[idx(-m), idx(-m)] = 1j * s2
    return U


# ---------------------------------------------------------------------------
# 3. CG tensor in the real basis
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor, shape [2l1+1, 2l2+1, 2l3+1].

    Defined so that if u transforms as l1 and v as l2 (real basis), then
    ``w_c = sum_ab C[a,b,c] u_a v_b`` transforms as l3.  Only parity-allowed
    paths (l1+l2+l3 even) are supported — those are the paths MACE's own
    irrep choices (SH-like parities) select; odd-sum paths would be purely
    imaginary in this construction (pseudotensors) and are rejected.
    """
    if (l1 + l2 + l3) % 2 != 0:
        raise ValueError(
            f"path {l1}x{l2}->{l3} is parity-forbidden under SH-like parities"
        )
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))

    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), dtype=np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                C[m1 + l1, m2 + l2, m3 + l3] = su2_cg(l1, l2, l3, m1, m2, m3)

    U1 = real_to_complex_U(l1)
    U2 = real_to_complex_U(l2)
    U3 = real_to_complex_U(l3)
    # C_real[a,b,c] = sum_{m1 m2 m3} U1[a,m1] U2[b,m2] conj(U3[c,m3]) C[m1,m2,m3]
    Cr = np.einsum("am,bn,co,mno->abc", U1, U2, np.conj(U3), C)
    assert np.max(np.abs(Cr.imag)) < 1e-12, "real CG has imaginary residue"
    out = np.ascontiguousarray(Cr.real)
    # Clean numerical dust for crisp sparsity tables.
    out[np.abs(out) < 1e-14] = 0.0
    return out


def cg_nonzeros(l1: int, l2: int, l3: int) -> List[Tuple[int, int, int, float]]:
    """Sparse (m1, m2, m3, value) list — the compile-time lookup table of the
    paper's Observation 2, consumed by the Pallas kernels."""
    C = real_cg(l1, l2, l3)
    out = []
    for a in range(C.shape[0]):
        for b in range(C.shape[1]):
            for c in range(C.shape[2]):
                v = C[a, b, c]
                if v != 0.0:
                    out.append((a, b, c, float(v)))
    return out


def cg_sparsity(l1: int, l2: int, l3: int) -> float:
    """Fraction of nonzero entries (paper claims typically < 20%)."""
    C = real_cg(l1, l2, l3)
    return float(np.count_nonzero(C)) / C.size


# ---------------------------------------------------------------------------
# 4. real SH as polynomials in (x, y, z)
# ---------------------------------------------------------------------------


def _assoc_legendre(l: int, m: int, x: np.ndarray) -> np.ndarray:
    """P_l^m with Condon-Shortley phase, m >= 0, via stable recursion."""
    assert 0 <= m <= l
    pmm = np.ones_like(x)
    if m > 0:
        somx2 = np.sqrt(np.maximum(0.0, (1.0 - x) * (1.0 + x)))
        fact = 1.0
        for _ in range(m):
            pmm = pmm * (-fact) * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2 * m + 1) * pmm
    if l == m + 1:
        return pmmp1
    pll = np.zeros_like(x)
    for ll in range(m + 2, l + 1):
        pll = ((2 * ll - 1) * x * pmmp1 - (ll + m - 1) * pmm) / (ll - m)
        pmm = pmmp1
        pmmp1 = pll
    return pll


def _complex_sh(l: int, m: int, xyz: np.ndarray) -> np.ndarray:
    """Orthonormal complex SH Y_l^m evaluated at unit vectors [N,3]."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    theta_cos = np.clip(z, -1.0, 1.0)
    phi = np.arctan2(y, x)
    am = abs(m)
    norm = math.sqrt(
        (2 * l + 1) / (4 * math.pi) * _fact(l - am) / _fact(l + am)
    )
    P = _assoc_legendre(l, am, theta_cos)
    Y = norm * P * np.exp(1j * am * phi)
    if m < 0:
        Y = ((-1) ** am) * np.conj(Y)
    return Y


def real_sh_values(l: int, xyz: np.ndarray) -> np.ndarray:
    """Real SH values [N, 2l+1] at unit vectors, normalised so Y_00 = 1."""
    Yc = np.stack([_complex_sh(l, m, xyz) for m in range(-l, l + 1)], axis=-1)
    U = real_to_complex_U(l)
    Yr = Yc @ U.T  # Y_real[n, a] = sum_m U[a, m] Yc[n, m]
    assert np.max(np.abs(Yr.imag)) < 1e-10
    return Yr.real * math.sqrt(4.0 * math.pi)


def monomial_exponents(l: int) -> List[Tuple[int, int, int]]:
    """All (a, b, c) with a+b+c = l, deterministic order."""
    out = []
    for a in range(l, -1, -1):
        for b in range(l - a, -1, -1):
            out.append((a, b, l - a - b))
    return out


@lru_cache(maxsize=None)
def real_sh_polys(l: int) -> np.ndarray:
    """Coefficient matrix [2l+1, n_monomials(l)] expressing each real SH as a
    homogeneous degree-l polynomial in (x, y, z) on the unit sphere."""
    rng = np.random.default_rng(0)
    n_mono = len(monomial_exponents(l))
    n_pts = max(64, 8 * n_mono)
    pts = rng.normal(size=(n_pts, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)

    A = np.stack(
        [
            pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c
            for (a, b, c) in monomial_exponents(l)
        ],
        axis=-1,
    )  # [N, n_mono]
    Y = real_sh_values(l, pts)  # [N, 2l+1]
    coeffs, *_ = np.linalg.lstsq(A, Y, rcond=None)
    coeffs = coeffs.T  # [2l+1, n_mono]
    coeffs[np.abs(coeffs) < 1e-10] = 0.0
    # Verify the fit is exact (SH are degree-l polynomials on the sphere).
    err = np.max(np.abs(A @ coeffs.T - Y))
    assert err < 1e-8, f"SH polynomial fit failed for l={l}: err={err}"
    return coeffs


# ---------------------------------------------------------------------------
# 5. real Wigner-D (test utility): Y(R x) = D(R) Y(x)
# ---------------------------------------------------------------------------


def wigner_D_real(l: int, R: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(max(64, 16 * (2 * l + 1)), 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    Y = real_sh_values(l, pts)          # [N, d]
    YR = real_sh_values(l, pts @ R.T)   # [N, d]
    # Solve YR = Y @ D^T  ->  D^T = lstsq(Y, YR)
    Dt, *_ = np.linalg.lstsq(Y, YR, rcond=None)
    return Dt.T


def random_rotation(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, 3))
    Q, r = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(r))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


# ---------------------------------------------------------------------------
# 6. generalized CG (U-tensors) for the symmetric contraction
# ---------------------------------------------------------------------------


def _lspec_dim(ls: Tuple[int, ...]) -> int:
    return sum(2 * l + 1 for l in ls)


def _lspec_slices(ls: Tuple[int, ...]) -> Dict[int, slice]:
    out, off = {}, 0
    for l in ls:
        out[l] = slice(off, off + 2 * l + 1)
        off += 2 * l + 1
    return out


@lru_cache(maxsize=None)
def u_tensor(ls_in: Tuple[int, ...], L: int, nu: int) -> np.ndarray:
    """Symmetrised generalized-CG tensor for correlation order ``nu``.

    Returns ``U`` with shape ``[d_in]*nu + [2L+1, n_paths]`` where
    ``d_in = sum(2l+1 for l in ls_in)``, such that

        B_{k,L,M} = sum_eta W_{k,eta} sum_{m1..m_nu}
                    U[m1, .., m_nu, M, eta] prod_x A_{k, m_x}

    is an equivariant (order-L) function of A, symmetric under permutation of
    the nu copies.  The path basis is orthonormal (SVD-reduced), spanning the
    same space as e3nn's reduced symmetric basis.
    """
    d = _lspec_dim(ls_in)
    sl = _lspec_slices(ls_in)
    dL = 2 * L + 1

    raw: List[np.ndarray] = []
    if nu == 1:
        if L in ls_in:
            T = np.zeros((d, dL))
            block = sl[L]
            T[block, :] = np.eye(dL)
            raw.append(T)
    elif nu == 2:
        for la in ls_in:
            for lb in ls_in:
                if not parity_ok(la, lb, L):
                    continue
                C = real_cg(la, lb, L)
                T = np.zeros((d, d, dL))
                T[sl[la], sl[lb], :] = C
                raw.append(T)
    elif nu == 3:
        for la in ls_in:
            for lb in ls_in:
                lint_min, lint_max = abs(la - lb), la + lb
                for lint in range(lint_min, lint_max + 1):
                    if (la + lb + lint) % 2 != 0:
                        continue
                    for lc in ls_in:
                        if not parity_ok(lint, lc, L):
                            continue
                        C1 = real_cg(la, lb, lint)        # [da, db, dint]
                        C2 = real_cg(lint, lc, L)          # [dint, dc, dL]
                        T = np.zeros((d, d, d, dL))
                        T[sl[la], sl[lb], sl[lc], :] = np.einsum(
                            "abi,icM->abcM", C1, C2
                        )
                        raw.append(T)
    else:
        raise NotImplementedError(f"nu={nu} not supported (use 1..3)")

    if not raw:
        return np.zeros(tuple([d] * nu) + (dL, 0))

    # Symmetrise over the nu input axes.
    import itertools

    sym: List[np.ndarray] = []
    for T in raw:
        acc = np.zeros_like(T)
        for perm in itertools.permutations(range(nu)):
            acc += np.transpose(T, perm + (nu,))
        sym.append(acc / math.factorial(nu))

    # Extract an orthonormal basis of the symmetrised path space.
    flat = np.stack([T.reshape(-1) for T in sym], axis=0)  # [p_raw, d^nu * dL]
    # SVD row-space reduction
    Umat, S, Vt = np.linalg.svd(flat, full_matrices=False)
    tol = max(flat.shape) * np.finfo(float).eps * (S[0] if S.size else 0.0)
    keep = S > max(tol, 1e-10)
    basis = Vt[keep]  # [n_paths, d^nu * dL], orthonormal rows
    n_paths = basis.shape[0]
    U = basis.T.reshape(tuple([d] * nu) + (dL, n_paths))
    U = np.ascontiguousarray(U)
    U[np.abs(U) < 1e-14] = 0.0
    return U


def parity_ok(l1: int, l2: int, l3: int) -> bool:
    return abs(l1 - l2) <= l3 <= l1 + l2 and (l1 + l2 + l3) % 2 == 0


def u_tensor_nonzeros(ls_in: Tuple[int, ...], L: int, nu: int):
    """Sparse representation of the U tensor: arrays (idx [nnz, nu], M [nnz],
    eta [nnz], val [nnz]) — compile-time tables for the fused kernel."""
    U = u_tensor(ls_in, L, nu)
    nz = np.nonzero(U)
    idx = np.stack(nz[:nu], axis=1).astype(np.int32)
    M = nz[nu].astype(np.int32)
    eta = nz[nu + 1].astype(np.int32)
    val = U[nz].astype(np.float64)
    return idx, M, eta, val
