"""Symmetric tensor contraction (paper Algorithm 3): raise the atomic basis
A_{i,k,lm} to correlation order nu, producing higher-body-order features

    B_{i,k,LM} = sum_{nu=1}^{nu_max} sum_eta W^{(nu)}_{z_i,k,eta}
                 sum_{m1..m_nu} U^{(L,nu)}[m1..m_nu, M, eta] prod_x A_{i,k,m_x}

with the generalized Clebsch-Gordan U tensors of :func:`repro_torch.core.cg.
u_tensor`.  Port of the JAX package's ``core/symmetric_contraction.py``:
the spec, the sparse tables and the init, and the two plain-torch
formulations, ``symcon_ref`` (the dense-U einsum baseline) and
``symcon_fused`` (the sparse tables, one gather, product and one-hot
scatter matmul per (L, nu)); the kernels live in ``repro_torch.kernels.
symmetric_contraction``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .cg import u_tensor, u_tensor_nonzeros
from .irreps import LSpec


@dataclasses.dataclass(frozen=True)
class SymConSpec:
    in_spec: LSpec         # irreps of A (e.g. 0+1+2+3)
    out_spec: LSpec        # irreps of B (e.g. 0+1)
    nu_max: int            # max correlation order (paper: 2; MACE default 3)

    def terms(self) -> List[Tuple[int, int]]:
        """All (L, nu) pairs with a nonempty path space."""
        out = []
        for L in self.out_spec:
            for nu in range(1, self.nu_max + 1):
                U = u_tensor(tuple(self.in_spec.ls), L, nu)
                if U.shape[-1] > 0:
                    out.append((L, nu))
        return out

    def n_paths(self, L: int, nu: int) -> int:
        return u_tensor(tuple(self.in_spec.ls), L, nu).shape[-1]

    def weight_shapes(self, n_species: int, channels: int):
        """Parameter shapes: {(L, nu): [n_species, channels, n_paths]}."""
        return {
            (L, nu): (n_species, channels, self.n_paths(L, nu))
            for (L, nu) in self.terms()
        }


def init_symcon_weights(
    generator: torch.Generator, spec: SymConSpec, n_species: int, channels: int
) -> Dict[str, torch.Tensor]:
    params = {}
    shapes = spec.weight_shapes(n_species, channels)
    for (L, nu), shp in sorted(shapes.items()):
        params[f"w_L{L}_nu{nu}"] = torch.randn(shp, generator=generator) / math.sqrt(
            shp[-1]
        )
    return params


@functools.lru_cache(maxsize=None)
def _dense_u(ls_in: Tuple[int, ...], L: int, nu: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    return torch.as_tensor(u_tensor(ls_in, L, nu), dtype=dtype, device=device)


def symcon_ref(
    A: torch.Tensor,            # [N, k, dim_in]
    species: torch.Tensor,      # [N] int
    weights: Dict[str, torch.Tensor],
    spec: SymConSpec,
) -> torch.Tensor:
    """Dense-U baseline (the e3nn-style contraction the paper measures its
    kernel against): one ``torch.einsum`` per (L, nu) over the dense U
    tensor, kept on A's device once per (L, nu).  Returns B: [N, k, dim_out]."""
    N, k, _ = A.shape
    out = A.new_zeros((N, k, spec.out_spec.dim))
    for (L, nu) in spec.terms():
        U = _dense_u(tuple(spec.in_spec.ls), L, nu, A.dtype, A.device)
        W = weights[f"w_L{L}_nu{nu}"][species]  # [N, k, n_paths]
        if nu == 1:
            bl = torch.einsum("aMe,nka,nke->nkM", U, A, W)
        elif nu == 2:
            bl = torch.einsum("abMe,nka,nkb,nke->nkM", U, A, A, W)
        elif nu == 3:
            bl = torch.einsum("abcMe,nka,nkb,nkc,nke->nkM", U, A, A, A, W)
        else:
            raise NotImplementedError(nu)
        out[:, :, spec.out_spec.slice_for(L)] += bl
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class SymConTables:
    """Sparse U tables per (L, nu).  Hashed by identity
    (``build_symcon_tables`` memoises one per spec), so the device copies of
    :func:`_fused_tensors` can be cached on it."""

    entries: Tuple[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray], ...]
    # each: (L, nu, idx [nnz, nu], M [nnz], eta [nnz], val [nnz])


@functools.lru_cache(maxsize=None)
def build_symcon_tables(spec: SymConSpec) -> SymConTables:
    """Build (and memoise per spec) the sparse U tables: nu_max=3 tables take
    minutes to enumerate, so every caller binding the same spec shares one
    build."""
    entries = []
    for (L, nu) in spec.terms():
        idx, M, eta, val = u_tensor_nonzeros(tuple(spec.in_spec.ls), L, nu)
        entries.append((L, nu, idx, M, eta, val))
    return SymConTables(tuple(entries))


@functools.lru_cache(maxsize=None)
def _fused_tensors(tables: SymConTables, dtype, device):
    """Per (L, nu) of ``tables``: the product columns [nnz, nu] and the
    weight columns [nnz] (long), the U values [nnz] and the one-hot [nnz,
    2L+1] projection onto M, on ``device``, made once per (tables, dtype,
    device): copies from the host at every call would make the stream wait
    on them, and a CUDA graph cannot capture them."""
    out = []
    for (L, nu, idx, M, eta, val) in tables.entries:
        scatter = np.zeros((len(M), 2 * L + 1), np.float64)
        scatter[np.arange(len(M)), M] = 1.0
        out.append((
            torch.as_tensor(idx, dtype=torch.long, device=device),
            torch.as_tensor(eta, dtype=torch.long, device=device),
            torch.as_tensor(val, dtype=dtype, device=device),
            torch.as_tensor(scatter, dtype=dtype, device=device),
        ))
    return tuple(out)


def symcon_fused(
    A: torch.Tensor,            # [N, k, dim_in]
    species: torch.Tensor,      # [N] int
    weights: Dict[str, torch.Tensor],
    spec: SymConSpec,
    tables: SymConTables | None = None,
) -> torch.Tensor:
    """Fused sparse-table implementation (the JAX ``symcon_fused``): per
    (L, nu) the nonzero products of A, times the gathered weights and the U
    values, summed onto the output's M components by a one-hot matmul.
    Returns B: [N, k, dim_out]."""
    t = tables or build_symcon_tables(spec)
    N, k, _ = A.shape
    out = A.new_zeros((N, k, spec.out_spec.dim))
    for (L, nu, *_), (cols, eta, val, scatter) in zip(
            t.entries, _fused_tensors(t, A.dtype, A.device)):
        W = weights[f"w_L{L}_nu{nu}"][species]                  # [N, k, n_paths]
        prod = A[:, :, cols[:, 0]]
        for x in range(1, nu):
            prod = prod * A[:, :, cols[:, x]]                    # [N, k, nnz]
        contrib = prod * W[:, :, eta] * val
        out[:, :, spec.out_spec.slice_for(L)] += contrib @ scatter
    return out
