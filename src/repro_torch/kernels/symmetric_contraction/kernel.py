"""Symmetric-contraction kernels (paper Algorithm 3) in kernel layout.

The CUDA kernels are ``csrc/symmetric_contraction.cu`` (``symcon_fwd``,
``symcon_bwd``); they replace the Pallas TPU kernels ``_symcon_kernel`` and
``_symcon_bwd_kernel`` of the JAX package's
``kernels/symmetric_contraction/kernel.py``.  Like the TPU kernels, which
unroll the CG groups at trace time, the source is built once per (spec,
precision) with a generated header (:func:`spec_header`) that unrolls the
groups of :func:`_group_entries` into straight-line scalar sums over one
(atom, channel)'s operands in registers.  Beside each kernel is its plain
PyTorch version over the same CG groups:

* :func:`symcon_plain` — port of the JAX ``symcon_xla_raw``;
* :func:`symcon_bwd_plain` — an explicit loop over the groups, the product
  rule of ``_symcon_bwd_kernel``.

Precision (``"fp32"``, ``"bf16"``, ``"fp8"``; ``kernels/precision.py``):
the bf16 and fp8 builds round every loaded operand (A and W; G in the
backward) and compute in fp32, as the TPU kernels' ``precision`` argument
does; the plain versions round the same operands with ``round_to``.

The wrappers :func:`symcon_fwd` and :func:`symcon_bwd` launch the kernel on
a CUDA tensor and take the plain version only for a CPU tensor.

Layout: A [N, d_in, k], W [N, P_total, k] (species-gathered, terms
concatenated along the path axis), B [N, d_out, k]; k minor.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.core.symmetric_contraction import (
    SymConSpec,
    SymConTables,
    build_symcon_tables,
)
from repro_torch.kernels.cuda_lib import (
    INT,
    PTR,
    CudaKernel,
    f32_literal,
    precision_define,
)
from repro_torch.kernels.precision import round_to

SYMCON_FWD = CudaKernel(
    "symmetric_contraction.cu", "symcon_fwd", [PTR] * 3 + [INT] * 2
)
SYMCON_BWD = CudaKernel(
    "symmetric_contraction.cu", "symcon_bwd", [PTR] * 5 + [INT] * 2
)
# round_op of a build on n values (a check of the rounding, off the model's path)
ROUND_VALUES = CudaKernel("symmetric_contraction.cu", "round_values", [PTR] * 2 + [INT])


def _group_entries(
    spec: SymConSpec, tables: SymConTables
) -> Tuple[List[Tuple[int, int, int, int, List[Tuple[Tuple[int, ...], float]]]], int]:
    """Flatten tables into per-(term, eta, M) entry groups.

    Returns (groups, P_total) where each group is
    (w_offset + eta, out_offset + M, nu, n_entries, [(idx_tuple, val), ...]).
    """
    groups = []
    w_off = 0
    for (L, nu, idx, M, eta, val) in tables.entries:
        out_off = spec.out_spec.slice_for(L).start
        n_paths = spec.n_paths(L, nu)
        buckets: Dict[Tuple[int, int], List[Tuple[Tuple[int, ...], float]]] = {}
        for e in range(len(val)):
            key = (int(eta[e]), int(M[e]))
            buckets.setdefault(key, []).append(
                (tuple(int(x) for x in idx[e]), float(val[e]))
            )
        for (et, m), ents in sorted(buckets.items()):
            groups.append((w_off + et, out_off + m, nu, len(ents), ents))
        w_off += n_paths
    return groups, w_off


@functools.lru_cache(maxsize=None)
def p_total_of(spec: SymConSpec) -> int:
    return _group_entries(spec, build_symcon_tables(spec))[1]


@functools.lru_cache(maxsize=None)
def spec_header(spec: SymConSpec, precision: str = "fp32") -> str:
    """The header ``csrc/symmetric_contraction.cu`` is built with for
    ``spec`` at ``precision``: the operand rounding (``PRECISION``), the
    spec's dimensions and the groups of :func:`_group_entries`, in table
    order, unrolled into straight-line scalar statements over one (atom,
    channel)'s operands in registers.

    ``symcon_contract(a, w, b)``, the forward: per group
    ``s = / += Π a[m_x] * val`` over its entries, then
    ``b[out] = / += w[eta] * s``.  ``symcon_transpose(a, w, g, da, dw)``,
    the backward: per group the same ``s``, ``dw[eta] = / += g[out] * s`` and
    ``const float gwJ = g[out] * w[eta]``; then, row by row of A, ``da[m] =
    / +=`` the product-rule terms ``gwJ * (Π_{y != x} a[m_y] * val)`` of the
    entries that hold m, in (group, entry, x) order.  A row that no group
    reaches is set to ``0.f``, so every output register is written by
    compile-time code."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    if any(nu > 3 for (_, _, nu, _, _) in groups):
        raise NotImplementedError("the CUDA symcon kernels take nu <= 3")
    d_in, d_out = spec.in_spec.dim, spec.out_spec.dim

    def sums(ents):
        return [f"  s {'=' if j == 0 else '+='} "
                f"{' * '.join([f'a[{m}]' for m in ix] + [f32_literal(v)])};"
                for j, (ix, v) in enumerate(ents)]

    def zeros(target, n, reached):
        return [f"  {target}[{r}] = 0.f;" for r in range(n) if r not in reached]

    fwd, bwd = [], []
    b_seen, dw_seen = set(), set()
    da_terms: Dict[int, List[str]] = {m: [] for m in range(d_in)}
    for j, (w_idx, out_idx, nu, _, ents) in enumerate(groups):
        fwd += sums(ents)
        fwd.append(f"  b[{out_idx}] {'+=' if out_idx in b_seen else '='} "
                   f"w[{w_idx}] * s;")
        b_seen.add(out_idx)
        bwd += sums(ents)
        bwd.append(f"  dw[{w_idx}] {'+=' if w_idx in dw_seen else '='} "
                   f"g[{out_idx}] * s;")
        dw_seen.add(w_idx)
        bwd.append(f"  const float gw{j} = g[{out_idx}] * w[{w_idx}];")
        for (ix, v) in ents:
            for x in range(nu):
                rest = [f"a[{m}]" for y, m in enumerate(ix) if y != x]
                da_terms[ix[x]].append(
                    f"gw{j} * ({' * '.join(rest + [f32_literal(v)])})" if rest
                    else f"gw{j} * {f32_literal(v)}")
    fwd += zeros("b", d_out, b_seen)
    bwd += zeros("dw", p_total, dw_seen)
    for m, terms in da_terms.items():
        if not terms:
            bwd.append(f"  da[{m}] = 0.f;")
        bwd += [f"  da[{m}] {'=' if j == 0 else '+='} {t};" for j, t in enumerate(terms)]
    return "\n".join([
        "// Generated by repro_torch/kernels/symmetric_contraction/kernel.py::spec_header",
        f"// for {spec!r}.",
        "#pragma once",
        precision_define(precision),
        f"constexpr int D_IN = {d_in}, P_TOTAL = {p_total}, D_OUT = {d_out};",
        "__device__ __forceinline__ void symcon_contract(",
        "    const float (&a)[D_IN], const float (&w)[P_TOTAL], float (&b)[D_OUT]) {",
        "  float s;",
        *fwd,
        "}",
        "__device__ __forceinline__ void symcon_transpose(",
        "    const float (&a)[D_IN], const float (&w)[P_TOTAL], const float (&g)[D_OUT],",
        "    float (&da)[D_IN], float (&dw)[P_TOTAL]) {",
        "  float s;",
        *bwd,
        "}",
        "",
    ])


def build_units(specs, precisions=("fp32",)):
    """The (source, header) build units of these specs' kernels at these
    precisions, for :func:`repro_torch.kernels.cuda_lib.build`."""
    return [("symmetric_contraction.cu", spec_header(spec, p))
            for spec in specs for p in precisions]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def symcon_plain(A_t: torch.Tensor, W_t: torch.Tensor, spec: SymConSpec,
                 precision: str = "fp32") -> torch.Tensor:
    """Port of the JAX ``symcon_xla_raw``: B_t [N, d_out, k], from A and W
    rounded to ``precision``."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    assert W_t.shape[1] == p_total, (W_t.shape, p_total)
    A_t, W_t = round_to(A_t, precision), round_to(W_t, precision)
    N, _, k = A_t.shape
    cols = [None] * spec.out_spec.dim
    for (w_idx, out_idx, nu, _, ents) in groups:
        s = None
        for (idx, val) in ents:
            t = A_t[:, idx[0], :]
            for x in range(1, nu):
                t = t * A_t[:, idx[x], :]
            term = t * val
            s = term if s is None else s + term
        c = W_t[:, w_idx, :] * s
        cols[out_idx] = c if cols[out_idx] is None else cols[out_idx] + c
    zeros = A_t.new_zeros((N, k))
    return torch.stack([c if c is not None else zeros for c in cols], dim=1)


def symcon_bwd_plain(
    A_t: torch.Tensor, W_t: torch.Tensor, G_t: torch.Tensor, spec: SymConSpec,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dA_t [N, d_in, k], dW_t [N, P_total, k] by the product rule, group by
    group (the sweep of the TPU ``_symcon_bwd_kernel``), from A, W and G
    rounded to ``precision``."""
    groups, p_total = _group_entries(spec, build_symcon_tables(spec))
    A_t, W_t, G_t = (round_to(t, precision) for t in (A_t, W_t, G_t))
    N, d_in, k = A_t.shape
    da = [None] * d_in
    dw = [None] * p_total

    def acc(buf, i, v):
        buf[i] = v if buf[i] is None else buf[i] + v

    for (w_idx, out_idx, nu, _, ents) in groups:
        g = G_t[:, out_idx, :]
        gw = g * W_t[:, w_idx, :]
        s = None
        for (idx, val) in ents:
            t = A_t[:, idx[0], :]
            for x in range(1, nu):
                t = t * A_t[:, idx[x], :]
            term = t * val
            s = term if s is None else s + term
            for x in range(nu):
                p = None
                for y in range(nu):
                    if y != x:
                        ay = A_t[:, idx[y], :]
                        p = ay if p is None else p * ay
                acc(da, idx[x], gw * val if p is None else gw * (p * val))
        acc(dw, w_idx, g * s)

    zeros = A_t.new_zeros((N, k))
    dA = torch.stack([zeros if c is None else c for c in da], dim=1)
    dW = torch.stack([zeros if c is None else c for c in dw], dim=1)
    return dA, dW


# ---------------------------------------------------------------------------
# wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(A_t, W_t, spec):
    if A_t.dim() != 3:
        raise ValueError(f"A_t must be [N, d_in, k], got {tuple(A_t.shape)}")
    N, d_in, k = A_t.shape
    if d_in != spec.in_spec.dim:
        raise ValueError(f"A_t has d_in={d_in}, spec wants {spec.in_spec.dim}")
    _check("A_t", A_t, (N, d_in, k), A_t.device)
    _check("W_t", W_t, (N, p_total_of(spec), k), A_t.device)
    if A_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A_t.device}")
    return N, d_in, k


def symcon_fwd(A_t: torch.Tensor, W_t: torch.Tensor, spec: SymConSpec,
               precision: str = "fp32") -> torch.Tensor:
    """B_t [N, d_out, k]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    N, d_in, k = _check_inputs(A_t, W_t, spec)
    if not A_t.is_cuda:
        return symcon_plain(A_t, W_t, spec, precision)
    d_out = spec.out_spec.dim
    B_t = torch.empty((N, d_out, k), dtype=A_t.dtype, device=A_t.device)
    if B_t.numel() == 0:
        return B_t
    SYMCON_FWD(A_t.data_ptr(), W_t.data_ptr(), B_t.data_ptr(), N, k,
               header=spec_header(spec, precision))
    return B_t


def symcon_bwd(
    A_t: torch.Tensor, W_t: torch.Tensor, G_t: torch.Tensor, spec: SymConSpec,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dA_t, dW_t): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    N, d_in, k = _check_inputs(A_t, W_t, spec)
    d_out = spec.out_spec.dim
    _check("G_t", G_t, (N, d_out, k), A_t.device)
    if not A_t.is_cuda:
        return symcon_bwd_plain(A_t, W_t, G_t, spec, precision)
    dA = torch.empty_like(A_t)
    dW = torch.empty_like(W_t)
    if dA.numel() == 0:
        return dA, dW
    SYMCON_BWD(A_t.data_ptr(), W_t.data_ptr(), G_t.data_ptr(), dA.data_ptr(),
               dW.data_ptr(), N, k, header=spec_header(spec, precision))
    return dA, dW


def round_on_card(x: torch.Tensor, spec: SymConSpec, precision: str) -> torch.Tensor:
    """``round_op`` of the ``(spec, precision)`` build on every element of
    the float32 CUDA tensor ``x``: the kernels' operand rounding, to hold
    against :func:`repro_torch.kernels.precision.round_to`."""
    if x.dtype != torch.float32 or not x.is_cuda or not x.is_contiguous():
        raise ValueError("round_on_card takes a contiguous float32 CUDA tensor")
    y = torch.empty_like(x)
    if x.numel():
        ROUND_VALUES(x.data_ptr(), y.data_ptr(), x.numel(),
                     header=spec_header(spec, precision))
    return y


def gather_weights(
    weights: Dict[str, torch.Tensor], species: torch.Tensor, spec: SymConSpec,
) -> torch.Tensor:
    """Per-atom weight gather + term concat: [N, k, P_total]."""
    parts = [
        weights[f"w_L{L}_nu{nu}"][species]  # [N, k, n_paths]
        for (L, nu, *_rest) in build_symcon_tables(spec).entries
    ]
    return torch.cat(parts, dim=-1)
