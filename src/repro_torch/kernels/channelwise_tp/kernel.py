"""Fused channelwise tensor product + edge->atom scatter kernels (paper
Algorithm 2) over the data pipeline's receiver-sorted edge tiles.

The CUDA kernels are ``csrc/channelwise_tp.cu`` (``tp_scatter_fwd``,
``tp_gather_bwd``); they replace the Pallas TPU kernels
``_tp_scatter_kernel`` and ``_tp_gather_bwd_kernel`` of the JAX package's
``kernels/channelwise_tp/kernel.py``.  The TPU did the scatter as a one-hot
MXU matmul per tile; on Hopper the forward gives each thread one (receiver
row, channel) of a tile and gathers that row's slots, and the backward
gives each thread one (slot, channel) (see the source's note).  Like the
TPU kernels, which unroll the CG entries at trace time, the source is built
once per spec with a generated header (:func:`spec_header`) that unrolls
the entries, grouped by one index, into straight-line scalar sums over
operands held in registers.  Beside each
kernel is its plain PyTorch version, an explicit loop over the same CG
entries:

* :func:`tp_scatter_plain` — messages per slot, then ``index_add_`` of the
  valid slots into their tile's rows;
* :func:`tp_gather_bwd_plain` — gather of each valid slot's receiver
  cotangent row, then the TP transpose entry by entry.

The wrappers :func:`tp_scatter` and :func:`tp_gather_bwd` launch the kernel
on CUDA tensors and take the plain version only for CPU tensors.

Layout (E_p = n_tiles * epb edge slots, slot s in tile s // epb):
Y_b [E_p, d_sh], h_b [E_p, d_h, k], R_b [E_p, n_paths, k], local [E_p]
int32 (receiver row inside the tile), valid [E_p] bool, A_t [n_tiles *
block_n, d_out, k]; k minor.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from repro_torch.core.channelwise_tp import TPSpec, build_tp_tables
from repro_torch.kernels.cuda_lib import INT, PTR, CudaKernel, f32_literal

# Limits of csrc/channelwise_tp.cu: a slot's Y is spread from one lane per
# component (d_sh <= 32, and d_h, d_out alike; the paper's widths, 16, fit
# the registers, at 25 the backward spills, see the source's note); the
# forward sorts a tile's slots in shared memory (epb <= 1024).
# Any k.
MAX_D = 32
MAX_EPB = 1024

TP_SCATTER_FWD = CudaKernel(
    "channelwise_tp.cu", "tp_scatter_fwd", [PTR] * 6 + [INT] * 8
)
TP_GATHER_BWD = CudaKernel(
    "channelwise_tp.cu", "tp_gather_bwd", [PTR] * 9 + [INT] * 8
)


def tp_entries(spec: TPSpec) -> List[Tuple[int, int, int, int, float]]:
    """The CG nonzeros as ``(m1, m2, m3, path, val)`` tuples."""
    t = build_tp_tables(spec)
    return [
        (int(t.m1[i]), int(t.m2[i]), int(t.m3[i]), int(t.path[i]), float(t.val[i]))
        for i in range(len(t.val))
    ]


@functools.lru_cache(maxsize=None)
def spec_dims(spec: TPSpec) -> Tuple[int, int, int, int]:
    """(d_sh, d_h, n_paths, d_out), computed once per spec."""
    return spec.y_spec.dim, spec.h_spec.dim, spec.n_paths, spec.out_spec.dim


def _grouped_sums(spec: TPSpec, key: str, target: str, term) -> List[str]:
    """``target[g] = / += term`` over the CG entries whose ``key`` is g, in
    table order, for every g; a group without entries is set to zero."""
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    field, n_groups = {"m1": (0, d_sh), "m2": (1, d_h), "m3": (2, d_out),
                       "path": (3, n_paths)}[key]
    entries = tp_entries(spec)
    lines = []
    for g in range(n_groups):
        group = [e for e in entries if e[field] == g]
        if not group:
            lines.append(f"  {target}[{g}] = 0.f;")
        for j, (m1, m2, m3, p, val) in enumerate(group):
            op = "=" if j == 0 else "+="
            lines.append(f"  {target}[{g}] {op} {term(m1, m2, m3, p, f32_literal(val))};")
    return lines


@functools.lru_cache(maxsize=None)
def spec_header(spec: TPSpec) -> str:
    """The header ``csrc/channelwise_tp.cu`` is built with for ``spec``: its
    dimensions and the CG entries unrolled, grouped by one index in table
    order, into straight-line scalar sums over operands in registers: the
    forward's messages by m3 (``tp_messages``); the backward's dh by m2, dR
    by path and per-channel dY by m1 (``tp_transpose``).  Each statement
    reads ``target[g] = / += term``."""
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    msg = _grouped_sums(spec, "m3", "msg",
                        lambda m1, m2, m3, p, v: f"(y[{m1}] * {v}) * h[{m2}] * r[{p}]")
    dh = _grouped_sums(spec, "m2", "dh",
                       lambda m1, m2, m3, p, v: f"(g[{m3}] * r[{p}]) * (y[{m1}] * {v})")
    dr = _grouped_sums(spec, "path", "dr",
                       lambda m1, m2, m3, p, v: f"(g[{m3}] * h[{m2}]) * (y[{m1}] * {v})")
    dy = _grouped_sums(spec, "m1", "dy",
                       lambda m1, m2, m3, p, v: f"g[{m3}] * h[{m2}] * r[{p}] * {v}")
    return "\n".join([
        "// Generated by repro_torch/kernels/channelwise_tp/kernel.py::spec_header",
        f"// for {spec!r}.",
        "#pragma once",
        f"constexpr int D_SH = {d_sh}, D_H = {d_h}, N_P = {n_paths}, D_OUT = {d_out};",
        "__device__ __forceinline__ void tp_messages(",
        "    const float (&y)[D_SH], const float (&h)[D_H], const float (&r)[N_P],",
        "    float (&msg)[D_OUT]) {",
        *msg,
        "}",
        "__device__ __forceinline__ void tp_transpose(",
        "    const float (&y)[D_SH], const float (&g)[D_OUT], const float (&h)[D_H],",
        "    const float (&r)[N_P], float (&dh)[D_H], float (&dr)[N_P],",
        "    float (&dy)[D_SH]) {",
        *dh,
        *dr,
        *dy,
        "}",
        "",
    ])


def build_units(specs):
    """The (source, header) build units of these specs' kernels, for
    :func:`repro_torch.kernels.cuda_lib.build`."""
    return [("channelwise_tp.cu", spec_header(spec)) for spec in specs]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _slot_rows(local: torch.Tensor, epb: int, block_n: int) -> torch.Tensor:
    """Row of each slot's receiver in the [n_tiles * block_n] tile layout."""
    tile = torch.arange(local.shape[0], device=local.device) // epb
    return tile * block_n + local.long()


def tp_scatter_plain(
    Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int
) -> torch.Tensor:
    """A_t [n_tiles * block_n, d_out, k]: per-slot messages summed into their
    tile's receiver rows; masked slots add nothing."""
    E_p, _, k = h_b.shape
    d_out = spec.out_spec.dim
    msg = [None] * d_out
    for (m1, m2, m3, p, val) in tp_entries(spec):
        contrib = (Y_b[:, m1, None] * val) * h_b[:, m2, :] * R_b[:, p, :]
        msg[m3] = contrib if msg[m3] is None else msg[m3] + contrib
    zeros = h_b.new_zeros((E_p, k))
    msgs = torch.stack([m if m is not None else zeros for m in msg], dim=1)
    rows = _slot_rows(local, E_p // n_tiles, block_n)
    out = h_b.new_zeros((n_tiles * block_n, d_out, k))
    return out.index_add_(0, rows[valid], msgs[valid])


def tp_gather_bwd_plain(
    G_t, Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY_b, dh_b, dR_b): each valid slot gathers its receiver's cotangent
    row, then the TP transpose; masked slots get exact zeros."""
    E_p, d_h, k = h_b.shape
    rows = _slot_rows(local, E_p // n_tiles, block_n)
    ge = torch.where(valid[:, None, None], G_t[rows], G_t.new_zeros(()))
    dy = [None] * Y_b.shape[1]
    dh = [None] * d_h
    dr = [None] * R_b.shape[1]

    def acc(buf, i, v):
        buf[i] = v if buf[i] is None else buf[i] + v

    for (m1, m2, m3, p, val) in tp_entries(spec):
        gm = ge[:, m3, :]
        y = Y_b[:, m1, None] * val
        h = h_b[:, m2, :]
        r = R_b[:, p, :]
        acc(dy, m1, torch.sum(gm * h * r, dim=1, keepdim=True) * val)
        acc(dh, m2, (gm * r) * y)
        acc(dr, p, (gm * h) * y)

    z1 = Y_b.new_zeros((E_p, 1))
    zk = h_b.new_zeros((E_p, k))
    return (
        torch.cat([c if c is not None else z1 for c in dy], dim=1),
        torch.stack([c if c is not None else zk for c in dh], dim=1),
        torch.stack([c if c is not None else zk for c in dr], dim=1),
    )


# ---------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------


def _check(name, t, shape, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(Y_b, h_b, R_b, local, valid, spec, n_tiles):
    if h_b.dim() != 3:
        raise ValueError(f"h_b must be [E_p, d_h, k], got {tuple(h_b.shape)}")
    E_p, d_h, k = h_b.shape
    dev = h_b.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if n_tiles <= 0 or E_p % n_tiles:
        raise ValueError(f"{E_p} edge slots do not split into {n_tiles} tiles")
    d_sh, d_h_spec, n_paths, d_out = spec_dims(spec)
    _check("Y_b", Y_b, (E_p, d_sh), torch.float32, dev)
    _check("h_b", h_b, (E_p, d_h_spec, k), torch.float32, dev)
    _check("R_b", R_b, (E_p, n_paths, k), torch.float32, dev)
    _check("local", local, (E_p,), torch.int32, dev)
    _check("valid", valid, (E_p,), torch.bool, dev)
    if dev.type == "cuda" and (max(d_sh, d_h, d_out) > MAX_D or E_p // n_tiles > MAX_EPB):
        raise ValueError(
            f"the CUDA kernels take d_sh, d_h, d_out <= {MAX_D} and at most "
            f"{MAX_EPB} slots per tile; got {spec_dims(spec)} and "
            f"{E_p // n_tiles} slots per tile"
        )
    return E_p, d_h, k


def tp_scatter(
    Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int
) -> torch.Tensor:
    """A_t [n_tiles * block_n, d_out, k]: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    E_p, d_h, k = _check_operands(Y_b, h_b, R_b, local, valid, spec, n_tiles)
    if not h_b.is_cuda:
        return tp_scatter_plain(
            Y_b, h_b, R_b, local, valid, spec, n_tiles=n_tiles, block_n=block_n
        )
    d_out = spec_dims(spec)[3]
    out = torch.empty((n_tiles * block_n, d_out, k), dtype=h_b.dtype, device=h_b.device)
    if out.numel() == 0:
        return out
    TP_SCATTER_FWD(
        Y_b.data_ptr(), h_b.data_ptr(), R_b.data_ptr(), local.data_ptr(),
        valid.data_ptr(), out.data_ptr(), n_tiles, E_p // n_tiles, block_n,
        *spec_dims(spec), k, header=spec_header(spec),
    )
    return out


def tp_gather_bwd(
    G_t, Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY_b, dh_b, dR_b): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    E_p, d_h, k = _check_operands(Y_b, h_b, R_b, local, valid, spec, n_tiles)
    d_out = spec_dims(spec)[3]
    _check("G_t", G_t, (n_tiles * block_n, d_out, k), torch.float32, h_b.device)
    if not h_b.is_cuda:
        return tp_gather_bwd_plain(
            G_t, Y_b, h_b, R_b, local, valid, spec, n_tiles=n_tiles, block_n=block_n
        )
    dY = torch.empty_like(Y_b)
    dh = torch.empty_like(h_b)
    dR = torch.empty_like(R_b)
    if E_p == 0 or k == 0:
        return dY.zero_(), dh, dR
    TP_GATHER_BWD(
        G_t.data_ptr(), Y_b.data_ptr(), h_b.data_ptr(), R_b.data_ptr(),
        local.data_ptr(), valid.data_ptr(), dY.data_ptr(), dh.data_ptr(),
        dR.data_ptr(), n_tiles, E_p // n_tiles, block_n, *spec_dims(spec), k,
        header=spec_header(spec),
    )
    return dY, dh, dR
