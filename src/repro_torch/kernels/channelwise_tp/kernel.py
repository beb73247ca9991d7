"""Fused channelwise tensor product + edge->atom scatter kernels (paper
Algorithm 2) over the data pipeline's receiver-sorted edge tiles.

The CUDA kernels are ``csrc/channelwise_tp.cu`` (``tp_scatter_fwd``,
``tp_gather_bwd``); they replace the Pallas TPU kernels
``_tp_scatter_kernel`` and ``_tp_gather_bwd_kernel`` of the JAX package's
``kernels/channelwise_tp/kernel.py``.  The TPU did the scatter as a one-hot
MXU matmul per tile; on Hopper each thread owns one channel of its tile's
output rows instead (see the source's note).  Beside each kernel is its
plain PyTorch version, an explicit loop over the same CG entries:

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

import numpy as np
import torch

from repro_torch.core.channelwise_tp import TPSpec, build_tp_tables
from repro_torch.kernels.cuda_lib import INT, PTR, CudaKernel

MAX_D = 32     # csrc/channelwise_tp.cu's per-thread d_out / d_sh arrays
MAX_K = 1024   # one thread per channel in a block

TP_SCATTER_FWD = CudaKernel(
    "channelwise_tp.cu", "tp_scatter_fwd", [PTR] * 8 + [INT] * 9
)
TP_GATHER_BWD = CudaKernel(
    "channelwise_tp.cu", "tp_gather_bwd", [PTR] * 11 + [INT] * 9
)


def tp_entries(spec: TPSpec) -> List[Tuple[int, int, int, int, float]]:
    """The CG nonzeros as ``(m1, m2, m3, path, val)`` tuples."""
    t = build_tp_tables(spec)
    return [
        (int(t.m1[i]), int(t.m2[i]), int(t.m3[i]), int(t.path[i]), float(t.val[i]))
        for i in range(len(t.val))
    ]


@functools.lru_cache(maxsize=None)
def device_tables(spec: TPSpec, device: torch.device):
    """(ent [nnz, 4] int32 (m1, m2, m3, path), ent_val [nnz] float32) on
    ``device``, built once per spec and device."""
    t = build_tp_tables(spec)
    ent = np.stack([t.m1, t.m2, t.m3, t.path], axis=1).astype(np.int32)
    return (
        torch.as_tensor(np.ascontiguousarray(ent), device=device),
        torch.as_tensor(t.val.astype(np.float32), device=device),
    )


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
    _check("Y_b", Y_b, (E_p, spec.y_spec.dim), torch.float32, dev)
    _check("h_b", h_b, (E_p, spec.h_spec.dim, k), torch.float32, dev)
    _check("R_b", R_b, (E_p, spec.n_paths, k), torch.float32, dev)
    _check("local", local, (E_p,), torch.int32, dev)
    _check("valid", valid, (E_p,), torch.bool, dev)
    if dev.type == "cuda" and (
        k > MAX_K or spec.y_spec.dim > MAX_D or spec.out_spec.dim > MAX_D
    ):
        raise ValueError(
            f"the CUDA kernels take k <= {MAX_K} and d_sh, d_out <= {MAX_D}"
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
    d_out = spec.out_spec.dim
    out = torch.empty((n_tiles * block_n, d_out, k), dtype=h_b.dtype, device=h_b.device)
    if out.numel() == 0:
        return out
    ent, ent_val = device_tables(spec, h_b.device)
    TP_SCATTER_FWD(
        Y_b.data_ptr(), h_b.data_ptr(), R_b.data_ptr(), local.data_ptr(),
        valid.data_ptr(), out.data_ptr(), ent.data_ptr(), ent_val.data_ptr(),
        ent.shape[0], n_tiles, E_p // n_tiles, block_n, Y_b.shape[1], d_h,
        R_b.shape[1], d_out, k,
    )
    return out


def tp_gather_bwd(
    G_t, Y_b, h_b, R_b, local, valid, spec: TPSpec, *, n_tiles: int, block_n: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dY_b, dh_b, dR_b): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    E_p, d_h, k = _check_operands(Y_b, h_b, R_b, local, valid, spec, n_tiles)
    d_out = spec.out_spec.dim
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
    ent, ent_val = device_tables(spec, h_b.device)
    TP_GATHER_BWD(
        G_t.data_ptr(), Y_b.data_ptr(), h_b.data_ptr(), R_b.data_ptr(),
        local.data_ptr(), valid.data_ptr(), dY.data_ptr(), dh.data_ptr(),
        dR.data_ptr(), ent.data_ptr(), ent_val.data_ptr(), ent.shape[0],
        n_tiles, E_p // n_tiles, block_n, Y_b.shape[1], d_h, R_b.shape[1],
        d_out, k,
    )
    return dY, dh, dR
