"""Channelwise tensor product (paper Algorithm 2): the edge-level operation

    A~_{ji,k,l3m3} = sum_{(l1,l2)->l3} R_{ji,k,(l1l2l3)}
                     sum_{m1,m2} C^{l3m3}_{l1m1,l2m2} Y_{ji,l1m1} h_{j,k,l2m2}

Port of the spec and table half of the JAX package's ``core/channelwise_tp.py``.
The tables are what the interaction kernels (``repro_torch.kernels.
channelwise_tp``) read; the ``tp_ref``/``tp_fused`` twins wait for the
training slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

from .cg import cg_nonzeros
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


@dataclasses.dataclass(frozen=True)
class TPTables:
    """Sparse CG tables, flattened across all paths."""

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
