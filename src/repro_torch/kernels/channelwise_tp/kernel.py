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
once per (spec, precision) with a generated header (:func:`spec_header`)
that unrolls the entries, grouped by one index, into straight-line scalar
sums over operands held in registers.  Beside each kernel is its plain
PyTorch version, an explicit loop over the same CG entries:

* :func:`tp_scatter_plain` — messages per slot, then ``index_add_`` of the
  valid slots into their tile's rows;
* :func:`tp_gather_bwd_plain` — gather of each valid slot's receiver
  cotangent row, then the TP transpose entry by entry.

Two more kernels, ``csrc/channelwise_tp_second.cu`` (``tp_dbl_scatter``,
``tp_dbl_gather``), are the blocked backward's own derivative, the second
order that training's force loss asks for; they replace no TPU kernel (the
JAX package leaves that derivative to XLA).  They read every operand row in
place through ``perm`` and the slots' senders, are fp32 at every
precision, and are built per spec from :func:`second_order_header`; beside
them :func:`tp_dbl_scatter_plain` and :func:`tp_dbl_gather_plain`.

Precision (``"fp32"``, ``"bf16"``, ``"fp8"``; ``kernels/precision.py``), as
the TPU kernels' ``precision`` argument: Y, h, R and the cotangent G are
rounded as they are loaded, and the forward rounds each slot's message
before the scatter; every sum is fp32.  One difference at fp8 overflow: a
message or cotangent that rounds to NaN reaches its own row or slot here,
where the reference's one-hot matmuls (``0 * NaN``) spread it over the tile.

The wrappers :func:`tp_scatter`, :func:`tp_gather_bwd`, :func:`tp_dbl_scatter`
and :func:`tp_dbl_gather` launch the kernel on CUDA tensors and take the
plain version only for CPU tensors.

Layout (E_p = n_tiles * epb edge slots, slot s in tile s // epb):
Y_b [E_p, d_sh], h_b [E_p, d_h, k], R_b [E_p, n_paths, k], local [E_p]
int32 (receiver row inside the tile), valid [E_p] bool, A_t [n_tiles *
block_n, d_out, k]; k minor.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.core.channelwise_tp import TPSpec, build_tp_tables
from repro_torch.kernels.cuda_lib import (
    INT,
    PTR,
    CudaKernel,
    f32_literal,
    precision_define,
)
from repro_torch.kernels.precision import round_to

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
TP_DBL_SCATTER = CudaKernel(
    "channelwise_tp_second.cu", "tp_dbl_scatter", [PTR] * 11 + [INT] * 8
)
TP_DBL_GATHER = CudaKernel(
    "channelwise_tp_second.cu", "tp_dbl_gather", [PTR] * 15 + [INT] * 7
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


def _grouped_sums(spec: TPSpec, key: str, target: str, term, add=None) -> List[str]:
    """``target[g] = / += term`` over the CG entries whose ``key`` is g, in
    table order, for every g; a group without entries is set to zero.  With
    ``add``, a later term is added as ``target[g] = add(target[g], term)``."""
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
            t = term(m1, m2, m3, p, f32_literal(val))
            if j == 0:
                lines.append(f"  {target}[{g}] = {t};")
            elif add is None:
                lines.append(f"  {target}[{g}] += {t};")
            else:
                lines.append(f"  {target}[{g}] = {add(f'{target}[{g}]', t)};")
    return lines


@functools.lru_cache(maxsize=None)
def spec_header(spec: TPSpec, precision: str = "fp32") -> str:
    """The header ``csrc/channelwise_tp.cu`` is built with for ``spec`` at
    ``precision``: the operand rounding (``PRECISION``), the spec's
    dimensions and the CG entries unrolled, grouped by one index in table
    order, into straight-line scalar sums over operands in registers: the
    forward's messages by m3 (``tp_messages``); the backward's dh by m2, dR
    by path and per-channel dY by m1 (``tp_transpose``).  Each statement
    reads ``target[g] = / += term``.  At a reduced precision the messages
    are formed with ``__fmul_rn`` / ``__fadd_rn``, which the compiler never
    fuses into a multiply-add, in :func:`tp_scatter_plain`'s order: each
    message is then the plain version's bit for bit, so both round it to
    the same value."""
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    if precision == "fp32":
        msg = _grouped_sums(spec, "m3", "msg", lambda m1, m2, m3, p, v: (
            f"(y[{m1}] * {v}) * h[{m2}] * r[{p}]"))
    else:  # every product and sum rounded on its own, never fused
        msg = _grouped_sums(
            spec, "m3", "msg",
            lambda m1, m2, m3, p, v: (
                f"__fmul_rn(__fmul_rn(__fmul_rn(y[{m1}], {v}), h[{m2}]), r[{p}])"),
            add=lambda acc, t: f"__fadd_rn({acc}, {t})")
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
        precision_define(precision),
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


def build_units(specs, precisions=("fp32",)):
    """The (source, header) build units of these specs' kernels at these
    precisions, for :func:`repro_torch.kernels.cuda_lib.build`."""
    return [("channelwise_tp.cu", spec_header(spec, p))
            for spec in specs for p in precisions]


# ---------------------------------------------------------------------------
# the second order (csrc/channelwise_tp_second.cu)
# ---------------------------------------------------------------------------

# outputs of a launch of the second-order gather (the source's OUT_*)
OUT_DR, OUT_DH, OUT_DY = 1, 2, 4
# floats a gather thread keeps live in one launch of all three outputs (its
# g, Y, cY, h, ch, R and cR and the three sums) above which the gather takes
# one launch per output, each holding four of the six operand rows: the
# paper's layer 1 (106) fits the 128 registers of four blocks an SM,
# MACE-MP-0 large's layer 1 (142) does not (PERF.md)
GATHER_LIVE_FLOATS = 112
# floats a scatter thread keeps live (its Y, cY, h, ch, R and cR, the
# messages and their sums) above which the scatter runs one block an SM,
# with up to 255 registers a thread, and not two of 128: the paper's layer 1
# (92) fits two, MACE-MP-0 large's layer 1 (116) spilled 368 bytes at 128
# (PERF.md)
SCATTER_LIVE_FLOATS = 100
# arithmetic operations of one CG entry for one (slot, channel) as the
# generated sums state them: the scatter's message (6 products, 3 sums), the
# gather's three sums (each 4 products, 2 sums)
SCATTER_ENTRY_OPS = 9
GATHER_ENTRY_OPS = 18


def gather_parts(spec: TPSpec) -> List[int]:
    """The outputs (``OUT_*`` masks) of each launch of ``spec``'s
    second-order gather: one launch of all three, or one per output when a
    thread's live floats pass ``GATHER_LIVE_FLOATS``."""
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    live = d_out + 2 * d_sh + 2 * (d_h + n_paths) + (d_sh + d_h + n_paths)
    if live <= GATHER_LIVE_FLOATS:
        return [OUT_DR | OUT_DH | OUT_DY]
    return [OUT_DR, OUT_DH, OUT_DY]


def scatter_min_blocks(spec: TPSpec) -> int:
    """Blocks an SM the second-order scatter is built for: 1 when a
    thread's live floats pass ``SCATTER_LIVE_FLOATS``, else 2."""
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    return 1 if 2 * (d_sh + d_h + n_paths + d_out) > SCATTER_LIVE_FLOATS else 2


@functools.lru_cache(maxsize=None)
def second_order_header(spec: TPSpec) -> str:
    """The header ``csrc/channelwise_tp_second.cu`` is built with for
    ``spec`` (fp32): its dimensions, the gather's launches
    (:func:`gather_parts`), the scatter's blocks an SM
    (:func:`scatter_min_blocks`) and the CG entries unrolled, grouped by
    one index in table order, into straight-line scalar sums over operands
    in registers: the scatter's messages by m3 (``tp_dbl_messages``), the
    gather's dh by m2, dR by path and per-channel dY by m1."""
    parts = gather_parts(spec)
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    msg = _grouped_sums(spec, "m3", "msg", lambda m1, m2, m3, p, v: (
        f"(cy[{m1}] * h[{m2}] * r[{p}] + y[{m1}] * (ch[{m2}] * r[{p}] + h[{m2}] * cr[{p}]))"
        f" * {v}"))
    dh = _grouped_sums(spec, "m2", "dh", lambda m1, m2, m3, p, v: (
        f"(g[{m3}] * {v}) * (cy[{m1}] * r[{p}] + y[{m1}] * cr[{p}])"))
    dr = _grouped_sums(spec, "path", "dr", lambda m1, m2, m3, p, v: (
        f"(g[{m3}] * {v}) * (cy[{m1}] * h[{m2}] + y[{m1}] * ch[{m2}])"))
    dy = _grouped_sums(spec, "m1", "dy", lambda m1, m2, m3, p, v: (
        f"(g[{m3}] * {v}) * (ch[{m2}] * r[{p}] + h[{m2}] * cr[{p}])"))
    fn = "__device__ __forceinline__ void"
    return "\n".join([
        "// Generated by repro_torch/kernels/channelwise_tp/kernel.py::second_order_header",
        f"// for {spec!r}.",
        "#pragma once",
        f"constexpr int D_SH = {d_sh}, D_H = {d_h}, N_P = {n_paths}, D_OUT = {d_out};",
        f"constexpr int GATHER_PARTS = {len(parts)};",
        f"constexpr int GATHER_OUTS[GATHER_PARTS] = {{{', '.join(map(str, parts))}}};",
        f"constexpr int SCATTER_MIN_BLOCKS = {scatter_min_blocks(spec)};",
        f"{fn} tp_dbl_messages(",
        "    const float (&y)[D_SH], const float (&cy)[D_SH], const float (&h)[D_H],",
        "    const float (&ch)[D_H], const float (&r)[N_P], const float (&cr)[N_P],",
        "    float (&msg)[D_OUT]) {",
        *msg,
        "}",
        f"{fn} tp_dbl_dh(",
        "    const float (&y)[D_SH], const float (&cy)[D_SH], const float (&g)[D_OUT],",
        "    const float (&r)[N_P], const float (&cr)[N_P], float (&dh)[D_H]) {",
        *dh,
        "}",
        f"{fn} tp_dbl_dr(",
        "    const float (&y)[D_SH], const float (&cy)[D_SH], const float (&g)[D_OUT],",
        "    const float (&h)[D_H], const float (&ch)[D_H], float (&dr)[N_P]) {",
        *dr,
        "}",
        f"{fn} tp_dbl_dy(",
        "    const float (&g)[D_OUT], const float (&h)[D_H], const float (&ch)[D_H],",
        "    const float (&r)[N_P], const float (&cr)[N_P], float (&dy)[D_SH]) {",
        *dy,
        "}",
        "",
    ])


def second_order_unit(spec: TPSpec):
    """The build unit of ``spec``'s second-order kernels (fp32 at every
    precision)."""
    return (TP_DBL_SCATTER.source, second_order_header(spec))


def second_order_work(spec: TPSpec, *, k: int, n_atoms: int, n_slots: int, n_valid: int,
                      n_tiles: int, block_n: int, rows_needed: int
                      ) -> Dict[str, Tuple[int, int]]:
    """``{kernel: (bytes, operations)}`` of one call of each second-order
    kernel over ``n_atoms`` atoms and ``n_slots`` slots of which ``n_valid``
    are valid, their receivers ``rows_needed`` distinct rows: the fewest
    bytes a call must move, each input read once (the edge operands at the
    valid slots, h and ch once per atom, G's needed rows, the index arrays)
    and each output written once at its own size (the scatter's tile rows;
    dY and dR at the valid slots, dh [n_atoms, d_h, k]), whatever the
    launches and the per-slot dh rows of the design; operations as
    :data:`SCATTER_ENTRY_OPS` / :data:`GATHER_ENTRY_OPS` per entry, valid
    slot and channel."""
    d_sh, d_h, n_paths, d_out = spec_dims(spec)
    nnz = len(tp_entries(spec))
    index = 5 * n_slots + 8 * n_valid   # valid and local a slot, perm and sender a valid one
    reads = 4 * 2 * (n_valid * (d_sh + n_paths * k) + n_atoms * d_h * k) + index
    scatter = reads + 4 * n_tiles * block_n * d_out * k
    gather = (reads + 4 * n_tiles + 4 * rows_needed * d_out * k
              + 4 * (n_valid * (d_sh + n_paths * k) + n_atoms * d_h * k))
    return {"tp_dbl_scatter": (scatter, SCATTER_ENTRY_OPS * n_valid * k * nnz),
            "tp_dbl_gather": (gather, GATHER_ENTRY_OPS * n_valid * k * nnz)}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _slot_rows(local: torch.Tensor, epb: int, block_n: int) -> torch.Tensor:
    """Row of each slot's receiver in the [n_tiles * block_n] tile layout."""
    tile = torch.arange(local.shape[0], device=local.device) // epb
    return tile * block_n + local.long()


def tp_scatter_plain(
    Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int,
    precision: str = "fp32",
) -> torch.Tensor:
    """A_t [n_tiles * block_n, d_out, k]: per-slot messages, from Y, h and R
    rounded to ``precision`` and rounded themselves, summed into their
    tile's receiver rows; masked slots add nothing."""
    E_p, _, k = h_b.shape
    Y_b, h_b, R_b = (round_to(t, precision) for t in (Y_b, h_b, R_b))
    d_out = spec.out_spec.dim
    msg = [None] * d_out
    for (m1, m2, m3, p, val) in tp_entries(spec):
        contrib = (Y_b[:, m1, None] * val) * h_b[:, m2, :] * R_b[:, p, :]
        msg[m3] = contrib if msg[m3] is None else msg[m3] + contrib
    zeros = h_b.new_zeros((E_p, k))
    msgs = round_to(torch.stack([m if m is not None else zeros for m in msg], dim=1),
                    precision)
    rows = _slot_rows(local, E_p // n_tiles, block_n)
    out = h_b.new_zeros((n_tiles * block_n, d_out, k))
    return out.index_add_(0, rows[valid], msgs[valid])


def tp_gather_bwd_plain(
    G_t, Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY_b, dh_b, dR_b): each valid slot gathers its receiver's cotangent
    row, then the TP transpose, with G, Y, h and R rounded to
    ``precision``; masked slots get exact zeros."""
    E_p, d_h, k = h_b.shape
    G_t, Y_b, h_b, R_b = (round_to(t, precision) for t in (G_t, Y_b, h_b, R_b))
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


def _dbl_slot_operands(Y, cY, h, ch, R, cR, perm, send):
    """Each slot's rows of the second order's operands: Y, cY, R and cR of
    its edge, h and ch ([N, d_h, k]) of its sender."""
    e, n = perm.long(), send.long()
    return Y[e], cY[e], h[n], ch[n], R[e], cR[e]


def tp_dbl_scatter_plain(
    Y, cY, h, ch, R, cR, perm, send, local, valid, spec: TPSpec, *, n_tiles: int,
    block_n: int,
) -> torch.Tensor:
    """dG_t [n_tiles * block_n, d_out, k]: per-slot messages of the three
    product-rule terms, ``cY h R + Y ch R + Y h cR``, summed into their
    tile's receiver rows; masked slots add nothing."""
    E_p, k = perm.shape[0], h.shape[2]
    y, cy, hs, chs, r, cr = _dbl_slot_operands(Y, cY, h, ch, R, cR, perm, send)
    msg = [None] * spec.out_spec.dim
    for (m1, m2, m3, p, val) in tp_entries(spec):
        t = (cy[:, m1, None] * hs[:, m2] * r[:, p]
             + y[:, m1, None] * (chs[:, m2] * r[:, p] + hs[:, m2] * cr[:, p])) * val
        msg[m3] = t if msg[m3] is None else msg[m3] + t
    zeros = h.new_zeros((E_p, k))
    msgs = torch.stack([m if m is not None else zeros for m in msg], dim=1)
    rows = _slot_rows(local, E_p // n_tiles, block_n)
    out = h.new_zeros((n_tiles * block_n, spec.out_spec.dim, k))
    return out.index_add_(0, rows[valid], msgs[valid])


def tp_dbl_gather_plain(
    G, Y, cY, h, ch, R, cR, perm, send, local, valid, base, spec: TPSpec, *,
    n_tiles: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY [E, d_sh], dR [E, n_paths, k], dh_b [E_p, d_h, k]): each valid
    slot gathers its receiver's row of G (``base[tile] + local``), then
    the product rule entry by entry; dY and dR land on the slot's edge
    (zeros on edges no valid slot holds), dh per slot, exact zeros on masked
    slots."""
    E_p, k = perm.shape[0], h.shape[2]
    d_sh, d_h, n_paths, _ = spec_dims(spec)
    y, cy, hs, chs, r, cr = _dbl_slot_operands(Y, cY, h, ch, R, cR, perm, send)
    tile = torch.arange(E_p, device=perm.device) // (E_p // n_tiles)
    rows = torch.where(valid, base.long()[tile] + local.long(), 0)
    ge = torch.where(valid[:, None, None], G[rows], G.new_zeros(()))
    dy = [None] * d_sh
    dh = [None] * d_h
    dr = [None] * n_paths

    def acc(buf, i, v):
        buf[i] = v if buf[i] is None else buf[i] + v

    for (m1, m2, m3, p, val) in tp_entries(spec):
        gv = ge[:, m3] * val
        acc(dh, m2, gv * (cy[:, m1, None] * r[:, p] + y[:, m1, None] * cr[:, p]))
        acc(dr, p, gv * (cy[:, m1, None] * hs[:, m2] + y[:, m1, None] * chs[:, m2]))
        acc(dy, m1, torch.sum(gv * (chs[:, m2] * r[:, p] + hs[:, m2] * cr[:, p]), dim=1,
                              keepdim=True))
    z1, zk = h.new_zeros((E_p, 1)), h.new_zeros((E_p, k))
    dy_s = torch.cat([c if c is not None else z1 for c in dy], dim=1)
    dr_s = torch.stack([c if c is not None else zk for c in dr], dim=1)
    dh_s = torch.stack([c if c is not None else zk for c in dh], dim=1)
    edges = perm.long()[valid]
    dY = Y.new_zeros(Y.shape)
    dY[edges] = dy_s[valid]
    dR = R.new_zeros(R.shape)
    dR[edges] = dr_s[valid]
    return dY, dR, torch.where(valid[:, None, None], dh_s, dh_s.new_zeros(()))


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
    Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int,
    precision: str = "fp32",
) -> torch.Tensor:
    """A_t [n_tiles * block_n, d_out, k]: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    E_p, d_h, k = _check_operands(Y_b, h_b, R_b, local, valid, spec, n_tiles)
    if not h_b.is_cuda:
        return tp_scatter_plain(
            Y_b, h_b, R_b, local, valid, spec, n_tiles=n_tiles, block_n=block_n,
            precision=precision,
        )
    d_out = spec_dims(spec)[3]
    out = torch.empty((n_tiles * block_n, d_out, k), dtype=h_b.dtype, device=h_b.device)
    if out.numel() == 0:
        return out
    TP_SCATTER_FWD(
        Y_b.data_ptr(), h_b.data_ptr(), R_b.data_ptr(), local.data_ptr(),
        valid.data_ptr(), out.data_ptr(), n_tiles, E_p // n_tiles, block_n,
        *spec_dims(spec), k, header=spec_header(spec, precision),
    )
    return out


def tp_gather_bwd(
    G_t, Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int,
    precision: str = "fp32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY_b, dh_b, dR_b): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    E_p, d_h, k = _check_operands(Y_b, h_b, R_b, local, valid, spec, n_tiles)
    d_out = spec_dims(spec)[3]
    _check("G_t", G_t, (n_tiles * block_n, d_out, k), torch.float32, h_b.device)
    if not h_b.is_cuda:
        return tp_gather_bwd_plain(
            G_t, Y_b, h_b, R_b, local, valid, spec, n_tiles=n_tiles, block_n=block_n,
            precision=precision,
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
        header=spec_header(spec, precision),
    )
    return dY, dh, dR


def _check_second_order(Y, cY, h, ch, R, cR, perm, send, local, valid, spec, n_tiles):
    if h.dim() != 3 or perm.dim() != 1:
        raise ValueError(f"h must be [N, d_h, k] and perm [E_p], got {tuple(h.shape)} "
                         f"and {tuple(perm.shape)}")
    N, _, k = h.shape
    E, E_p, dev = Y.shape[0], perm.shape[0], h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if n_tiles <= 0 or E_p % n_tiles:
        raise ValueError(f"{E_p} edge slots do not split into {n_tiles} tiles")
    d_sh, d_h, n_paths, _ = spec_dims(spec)
    for name, t, shape in (("Y", Y, (E, d_sh)), ("cY", cY, (E, d_sh)),
                           ("h", h, (N, d_h, k)), ("ch", ch, (N, d_h, k)),
                           ("R", R, (E, n_paths, k)), ("cR", cR, (E, n_paths, k))):
        _check(name, t, shape, torch.float32, dev)
    for name, t in (("perm", perm), ("send", send), ("local", local)):
        _check(name, t, (E_p,), torch.int32, dev)
    _check("valid", valid, (E_p,), torch.bool, dev)
    if dev.type == "cuda" and (max(spec_dims(spec)) > MAX_D or E_p // n_tiles > MAX_EPB):
        raise ValueError(
            f"the CUDA kernels take d_sh, d_h, d_out <= {MAX_D} and at most "
            f"{MAX_EPB} slots per tile; got {spec_dims(spec)} and "
            f"{E_p // n_tiles} slots per tile"
        )
    return E_p, k


def tp_dbl_scatter(
    Y, cY, h, ch, R, cR, perm, send, local, valid, spec: TPSpec, *, n_tiles: int,
    block_n: int,
) -> torch.Tensor:
    """dG_t [n_tiles * block_n, d_out, k], the second order's receiver
    scatter, fp32: the CUDA kernel for CUDA tensors (one launch), the plain
    version for CPU tensors.  Y, cY [E, d_sh], R, cR [E, n_paths, k] in edge
    order, h, ch [N, d_h, k] in node order; ``perm`` and ``send`` (the
    senders of the slots' edges) int32 [E_p]."""
    E_p, k = _check_second_order(Y, cY, h, ch, R, cR, perm, send, local, valid, spec,
                                 n_tiles)
    if not h.is_cuda:
        return tp_dbl_scatter_plain(Y, cY, h, ch, R, cR, perm, send, local, valid, spec,
                                    n_tiles=n_tiles, block_n=block_n)
    out = torch.empty((n_tiles * block_n, spec_dims(spec)[3], k), dtype=h.dtype,
                      device=h.device)
    if out.numel() == 0:
        return out
    TP_DBL_SCATTER(
        *(t.data_ptr() for t in (Y, cY, h, ch, R, cR, perm, send, local, valid, out)),
        n_tiles, E_p // n_tiles, block_n, *spec_dims(spec), k,
        header=second_order_header(spec),
    )
    return out


def tp_dbl_gather(
    G, Y, cY, h, ch, R, cR, perm, send, local, valid, base, spec: TPSpec, *,
    n_tiles: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY [E, d_sh], dR [E, n_paths, k], dh_b [E_p, d_h, k]), the second
    order's per-slot gather of the cotangent rows ``G`` [N, d_out, k], fp32:
    the CUDA kernel for CUDA tensors (one launch per part of
    :func:`gather_parts`, each counted), the plain version for CPU
    tensors."""
    E_p, k = _check_second_order(Y, cY, h, ch, R, cR, perm, send, local, valid, spec,
                                 n_tiles)
    _check("G", G, (h.shape[0], spec_dims(spec)[3], k), torch.float32, h.device)
    _check("base", base, (n_tiles,), torch.int32, h.device)
    if not h.is_cuda:
        return tp_dbl_gather_plain(G, Y, cY, h, ch, R, cR, perm, send, local, valid, base,
                                   spec, n_tiles=n_tiles)
    dY, dR = torch.zeros_like(Y), torch.zeros_like(R)
    dh = torch.empty((E_p, spec_dims(spec)[1], k), dtype=h.dtype, device=h.device)
    if E_p == 0 or k == 0:
        return dY, dR, dh
    TP_DBL_GATHER(
        *(t.data_ptr() for t in (G, Y, cY, h, ch, R, cR, perm, send, local, valid, base,
                                 dY, dR, dh)),
        n_tiles, E_p // n_tiles, *spec_dims(spec), k,
        header=second_order_header(spec), launches=len(gather_parts(spec)),
    )
    return dY, dR, dh
