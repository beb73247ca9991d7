"""Channelwise tensor product (paper Algorithm 2): the edge-level operation

    A~_{ji,k,l3m3} = sum_{(l1,l2)->l3} R_{ji,k,(l1l2l3)}
                     sum_{m1,m2} C^{l3m3}_{l1m1,l2m2} Y_{ji,l1m1} h_{j,k,l2m2}

Port of the JAX package's ``core/channelwise_tp.py``: the spec and the
sparse CG tables, which the interaction kernels (``repro_torch.kernels.
channelwise_tp``) unroll, and the two plain-torch formulations:

* :func:`tp_ref` — one dense einsum per CG path (the e3nn-style oracle);
* :func:`tp_fused` — the per-edge contributions in the nnz basis
  (:func:`tp_contrib`) times the one-hot m3 projection
  (:func:`cg_scatter_matrix`): the twin whose autodiff is the derivative
  of the interaction backward kernel (``core.interaction.interaction_fused``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from .cg import cg_nonzeros, real_cg
from .irreps import LSpec, tp_paths


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """Static description of a channelwise tensor product."""

    y_spec: LSpec     # spherical harmonics irreps (edge attr)
    h_spec: LSpec     # node feature irreps (sender)
    out_spec: LSpec   # output (atomic basis A) irreps

    @property
    def paths(self) -> List[Tuple[int, int, int]]:
        return tp_paths(self.y_spec, self.h_spec, self.out_spec)

    @property
    def n_paths(self) -> int:
        return len(self.paths)


@dataclasses.dataclass(frozen=True, eq=False)
class TPTables:
    """Sparse CG tables, flattened across all paths.  Hashed by identity
    (``build_tp_tables`` memoises one per spec), so the device copies of
    :func:`_table_tensor` can be cached on it."""

    m1: np.ndarray      # [nnz] index into y dim
    m2: np.ndarray      # [nnz] index into h dim
    m3: np.ndarray      # [nnz] index into out dim
    path: np.ndarray    # [nnz] path id (for the radial weight gather)
    val: np.ndarray     # [nnz]
    dim_out: int
    n_paths: int


@functools.lru_cache(maxsize=None)
def build_tp_tables(spec: TPSpec) -> TPTables:
    """Build (and memoise per spec) the flattened sparse CG tables."""
    m1l, m2l, m3l, pl, vl = [], [], [], [], []
    for p, (l1, l2, l3) in enumerate(spec.paths):
        o1 = spec.y_spec.slice_for(l1).start
        o2 = spec.h_spec.slice_for(l2).start
        o3 = spec.out_spec.slice_for(l3).start
        for (a, b, c, v) in cg_nonzeros(l1, l2, l3):
            m1l.append(o1 + a)
            m2l.append(o2 + b)
            m3l.append(o3 + c)
            pl.append(p)
            vl.append(v)
    return TPTables(
        m1=np.asarray(m1l, np.int32),
        m2=np.asarray(m2l, np.int32),
        m3=np.asarray(m3l, np.int32),
        path=np.asarray(pl, np.int32),
        val=np.asarray(vl, np.float64),
        dim_out=spec.out_spec.dim,
        n_paths=spec.n_paths,
    )


@functools.lru_cache(maxsize=None)
def _real_cg_tensor(l1: int, l2: int, l3: int, dtype, device) -> torch.Tensor:
    """``real_cg(l1, l2, l3)`` on ``device``, made once per (path, dtype,
    device), so that ``tp_ref`` copies nothing from the host per call (a
    CUDA graph cannot capture such a copy)."""
    return torch.as_tensor(real_cg(l1, l2, l3), dtype=dtype, device=device)


def tp_ref(
    Y: torch.Tensor,       # [E, dim_y]
    h_send: torch.Tensor,  # [E, k, dim_h]   (already gathered to edges)
    R: torch.Tensor,       # [E, n_paths, k]
    spec: TPSpec,
) -> torch.Tensor:
    """Baseline: one dense einsum per CG path (e3nn-style op chain)."""
    E, k = h_send.shape[0], h_send.shape[1]
    out = h_send.new_zeros((E, k, spec.out_spec.dim))
    for p, (l1, l2, l3) in enumerate(spec.paths):
        C = _real_cg_tensor(l1, l2, l3, h_send.dtype, h_send.device)
        y_p = Y[:, spec.y_spec.slice_for(l1)]
        h_p = h_send[:, :, spec.h_spec.slice_for(l2)]
        r_p = R[:, p, :]
        block = torch.einsum("abc,ea,ekb->ekc", C, y_p, h_p) * r_p[:, :, None]
        out[:, :, spec.out_spec.slice_for(l3)] += block
    return out


@functools.lru_cache(maxsize=None)
def _table_tensor(tables: TPTables, name: str, depth: int, dtype,
                  device) -> torch.Tensor:
    """A table as a tensor on ``device``, made once per (tables, dtype,
    device): ``"val"`` is the CG values [nnz]; any other name is a [depth,
    nnz] one-hot of that index column, so ``x @ onehot`` is ``x[...,
    idx]`` exactly (each column sums one product with 1.0).  Cached because
    the twin runs once per edge chunk, and a fresh copy from the host each
    call would make the stream wait on it."""
    if name == "val":
        return torch.as_tensor(tables.val, dtype=dtype, device=device)
    idx = getattr(tables, name)
    out = np.zeros((depth, len(idx)), np.float64)
    out[idx, np.arange(len(idx))] = 1.0
    return torch.as_tensor(out, dtype=dtype, device=device)


def tp_contrib(
    Y: torch.Tensor,       # [E, dim_y]
    h_send: torch.Tensor,  # [E, k, dim_h]
    R: torch.Tensor,       # [E, n_paths, k]
    tables: TPTables,
) -> torch.Tensor:
    """Per-edge CG contributions in the *nnz basis*: [E, k, nnz].  The m3
    projection (:func:`cg_scatter_matrix`) is linear, so it commutes with
    any linear pooling over edges.

    The three column gathers of the JAX ``tp_contrib`` are products with
    one-hot matrices here: the same values, but their autodiff (twice, in
    the second-order rule of the interaction op) is a matrix product
    rather than PyTorch's sort-based indexing backward."""
    dt, dev = h_send.dtype, h_send.device
    val = _table_tensor(tables, "val", 0, dt, dev)
    yg = Y @ _table_tensor(tables, "m1", Y.shape[1], dt, dev)                   # [E, nnz]
    hg = h_send @ _table_tensor(tables, "m2", h_send.shape[2], dt, dev)         # [E, k, nnz]
    rg = R.transpose(1, 2) @ _table_tensor(tables, "path", R.shape[1], dt, dev)  # [E, k, nnz]
    return (yg[:, None, :] * val) * hg * rg


def cg_scatter_matrix(tables: TPTables, dtype, device=None) -> torch.Tensor:
    """[nnz, dim_out] one-hot m3 projection."""
    return _table_tensor(tables, "m3", tables.dim_out, dtype, device).T


def tp_fused(
    Y: torch.Tensor,
    h_send: torch.Tensor,
    R: torch.Tensor,
    spec: TPSpec,
    tables: TPTables | None = None,
) -> torch.Tensor:
    """Fused sparse-table formulation: one gather per operand and one
    matmul.  [E, k, dim_out]."""
    t = tables or build_tp_tables(spec)
    return tp_contrib(Y, h_send, R, t) @ cg_scatter_matrix(
        t, h_send.dtype, h_send.device)
