"""Static-shape collation of molecular graphs into padded device batches.

A *bin* (the paper's minibatch) is collated to fixed node/edge/graph counts
so every training step hits the same compiled program regardless of which
graphs Algorithm 1 placed in the bin — padding is the memory objective the
packer minimises (Eq. 4).

``with_blocking=True`` additionally emits the fused-interaction kernel's
pre-blocked edge arrays (``blk_*`` keys; see ``data.blocking``) — host-side
numpy work that runs right next to Algorithm-1 collation, so the prefetch
pipeline hides it behind device compute.  Blocking shapes are a pure
function of the :class:`BinShape` (``blocking_tiles``), keeping jit
recompiles bounded and per-rank blockings stackable to ``[R, ...]``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .blocking import (
    DEFAULT_BLOCK_E,
    DEFAULT_BLOCK_N,
    block_edges,
    blocking_to_batch,
    static_n_tiles,
)
from .molecules import Molecule


@dataclasses.dataclass(frozen=True)
class BinShape:
    """Static shapes for one bin; derived from capacity once per run."""

    max_nodes: int           # == bin capacity C
    max_edges: int           # C * edge_factor
    max_graphs: int
    # fused-interaction edge blocking (see data.blocking): atom rows / edge
    # slots per kernel tile
    block_n: int = DEFAULT_BLOCK_N
    block_e: int = DEFAULT_BLOCK_E

    @property
    def blocking_tiles(self) -> int:
        """Static tile count for this shape's blocking arrays."""
        return static_n_tiles(
            self.max_edges, self.max_nodes, self.block_n, self.block_e
        )

    @staticmethod
    def for_capacity(
        capacity: int,
        edge_factor: int = 24,
        max_graphs: Optional[int] = None,
        *,
        block_n: int = DEFAULT_BLOCK_N,
        block_e: int = DEFAULT_BLOCK_E,
    ):
        return BinShape(
            max_nodes=capacity,
            max_edges=capacity * edge_factor,
            max_graphs=max_graphs or max(8, capacity // 8),
            block_n=block_n,
            block_e=block_e,
        )


def bin_blocking_arrays(
    col: Dict[str, np.ndarray], shape: BinShape
) -> Dict[str, np.ndarray]:
    """Shape-stable ``blk_*`` arrays for one collated bin."""
    return blocking_to_batch(
        block_edges(
            col["receivers"], col["edge_mask"], shape.max_nodes,
            block_n=shape.block_n, block_e=shape.block_e,
            n_tiles=shape.blocking_tiles,
        )
    )


def collate_bin(
    mols: Sequence[Molecule], shape: BinShape, *, strict: bool = False,
    with_blocking: bool = False, timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """Concatenate graphs block-diagonally (Fig. 3) and pad to ``shape``.

    ``timings`` (optional, mutated) accumulates the host seconds spent on
    edge blocking under ``"block_s"`` so callers (the engines) can
    attribute the fused-interaction preprocessing in telemetry."""
    N, E, G = shape.max_nodes, shape.max_edges, shape.max_graphs
    n_tot = sum(m.n_atoms for m in mols)
    e_tot = sum(m.n_edges for m in mols)
    if n_tot > N or len(mols) > G:
        raise ValueError(f"bin overflow: nodes {n_tot}/{N} graphs {len(mols)}/{G}")
    if e_tot > E:
        if strict:
            raise ValueError(f"edge overflow: {e_tot}/{E}")
        # drop whole trailing graphs until it fits (never silently truncate edges)
        kept: List[Molecule] = []
        acc = 0
        for m in mols:
            if acc + m.n_edges <= E:
                kept.append(m)
                acc += m.n_edges
        mols = kept

    species = np.zeros(N, np.int32)
    positions = np.zeros((N, 3), np.float32)
    node_mask = np.zeros(N, bool)
    senders = np.zeros(E, np.int32)
    receivers = np.zeros(E, np.int32)
    edge_mask = np.zeros(E, bool)
    graph_id = np.zeros(N, np.int32)
    energy = np.zeros(G, np.float32)
    forces = np.zeros((N, 3), np.float32)

    n_off = e_off = 0
    for g, m in enumerate(mols):
        n, e = m.n_atoms, m.n_edges
        species[n_off : n_off + n] = m.species
        positions[n_off : n_off + n] = m.positions
        node_mask[n_off : n_off + n] = True
        graph_id[n_off : n_off + n] = g
        senders[e_off : e_off + e] = m.senders + n_off
        receivers[e_off : e_off + e] = m.receivers + n_off
        edge_mask[e_off : e_off + e] = True
        energy[g] = m.energy
        forces[n_off : n_off + n] = m.forces
        n_off += n
        e_off += e

    # padded nodes join a dedicated spare graph slot (zero weight in loss)
    graph_id[n_off:] = G - 1
    out = {
        "species": species,
        "positions": positions,
        "node_mask": node_mask,
        "senders": senders,
        "receivers": receivers,
        "edge_mask": edge_mask,
        "graph_id": graph_id,
        "energy": energy,
        "forces": forces,
    }
    if with_blocking:
        t0 = time.perf_counter()
        out.update(bin_blocking_arrays(out, shape))
        if timings is not None:
            timings["block_s"] = (
                timings.get("block_s", 0.0) + time.perf_counter() - t0
            )
    return out


def collate_stacked(
    mols_per_rank: Sequence[Sequence[Molecule]],
    shape: BinShape,
    *,
    strict: bool = False,
    with_blocking: bool = False,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """Collate R per-rank bins and stack them on a leading ``[R, ...]`` axis.

    This is the device layout the ``ShardMapEngine`` consumes: axis 0 is the
    data-parallel mesh axis, so sharding the result with ``P("data", ...)``
    puts exactly one collated bin on each rank.  Every rank shares the same
    static ``BinShape`` — a requirement for SPMD (one compiled program) that
    Algorithm 1's capacity bound guarantees.
    """
    if not mols_per_rank:
        raise ValueError("need at least one rank's bin")
    cols = [
        collate_bin(m, shape, strict=strict, with_blocking=with_blocking,
                    timings=timings)
        for m in mols_per_rank
    ]
    return {k: np.stack([c[k] for c in cols]) for k in cols[0]}
