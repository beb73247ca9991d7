"""Host-side edge blocking for the fused TP+scatter interaction kernel.

The paper's kernel (§4) scatters per-edge messages into per-atom rows inside
the kernel instead of materializing an ``[E, k, d_out]`` message tensor.  The
TPU adaptation (``kernels/channelwise_tp``) needs the edges *pre-sorted by
receiver and grouped into fixed-size tiles* so the scatter becomes a one-hot
MXU matmul per tile.  That grouping is pure numpy index work — it belongs in
the data pipeline, next to Algorithm-1 collation, where the prefetch pipeline
hides it behind device compute.

Layout ("virtual tiles")
------------------------
Valid edges are stably sorted by receiver and packed into tiles of exactly
``block_e`` edge slots.  Each tile owns a *base atom row* (``tile_base``) and
covers receivers in ``[base, base + block_n)``; a new tile starts whenever
the current one is full *or* the receiver leaves the ``block_n``-atom window.
Because a window can emit several tiles, hub atoms (receiver degree larger
than ``block_e``) never overflow a tile — they just occupy more tiles with
the same base.  The kernel writes one ``[block_n, d_out, k]`` output row
block per tile; a cheap length-``T*block_n`` segment-add at ``tile_base[t] +
local_rcv`` folds overlapping tiles back into atom rows.

Shape stability
---------------
The tile count is padded to the *static* worst case for a batch shape,

    n_tiles(E_max, N_max) = ceil(N_max / block_n) + floor(E_max / block_e)

(every tile except one per atom window is full), so every bin collated to
the same ``BinShape`` produces identically-shaped blocking arrays: jit
recompiles stay bounded, and per-rank blockings stack to ``[R, ...]`` for
``collate_stacked``.

Batch contract
--------------
``blocking_to_batch`` flattens an :class:`EdgeBlocking` into four plain
arrays under reserved batch keys (``blk_perm``, ``blk_valid``, ``blk_local``,
``blk_base``) that ride through collation, prefetch, and both engines like
any other batch field.  ``core.mace`` picks them up (``blocking_from_batch``)
and hands them to the registered ``interaction`` kernel; ``block_n`` is the
one static parameter that cannot travel in an array and must match between
``BinShape.block_n`` and ``MaceConfig.interaction_block_n`` (the Trainer
validates this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# Defaults shared by BinShape and MaceConfig; 32 atom rows x 128 edge lanes
# matches the Pallas kernel's MXU-friendly tile.
DEFAULT_BLOCK_N = 32
DEFAULT_BLOCK_E = 128

# Reserved batch keys carrying a flattened EdgeBlocking (see module docstring).
BLOCKING_BATCH_KEYS = ("blk_perm", "blk_valid", "blk_local", "blk_base")


@dataclasses.dataclass(frozen=True)
class EdgeBlocking:
    """Static edge blocking for one collated bin."""

    perm: np.ndarray        # [T*epb] int32 -> original edge id (padding -> 0)
    valid: np.ndarray       # [T*epb] bool
    local_rcv: np.ndarray   # [T*epb] int32 receiver offset within the tile
    tile_base: np.ndarray   # [T] int32 first atom row covered by the tile
    block_n: int            # atom rows per tile
    epb: int                # edge slots per tile (== block_e)

    @property
    def n_atom_tiles(self) -> int:
        return int(self.tile_base.shape[0])


def static_n_tiles(
    max_edges: int,
    max_nodes: int,
    block_n: int = DEFAULT_BLOCK_N,
    block_e: int = DEFAULT_BLOCK_E,
) -> int:
    """Worst-case tile count for a batch shape (see module docstring)."""
    return -(-max_nodes // block_n) + max_edges // block_e


def block_size_candidates(max_nodes: int, max_edges: int):
    """Valid ``(block_n, block_e)`` tile geometries for a batch shape — the
    kernel autotuner's search space (``kernels.autotune``).

    Shape-stability rule: the blocking arrays are a pure function of
    ``(BinShape, block_n, block_e)``, so any candidate pair is shape-stable
    per bin — but it must (a) keep the TPU tile layout legal (``block_n`` a
    multiple of 8 sublanes, ``block_e`` of 128 lanes), (b) not exceed the
    batch dims, and (c) keep the static worst-case tile count positive and
    sane.  The default geometry is always first so deterministic tie-breaks
    land on it."""
    cands = []
    for bn in (DEFAULT_BLOCK_N, 8, 16, 64):
        if bn > max_nodes or bn % 8:
            continue
        for be in (DEFAULT_BLOCK_E, 256, 512):
            if be > max_edges or be % 128:
                continue
            if (bn, be) not in cands and static_n_tiles(
                max_edges, max_nodes, bn, be
            ) > 0:
                cands.append((bn, be))
    return cands or [(min(DEFAULT_BLOCK_N, max_nodes), max_edges)]


def block_edges(
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    n_atoms: int,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    block_e: int = DEFAULT_BLOCK_E,
    n_tiles: Optional[int] = None,
) -> EdgeBlocking:
    """Deterministic, fully vectorized edge blocking (no per-edge Python).

    ``n_tiles`` defaults to the static worst case for ``(len(receivers),
    n_atoms)``, making the output shape a pure function of the batch shape.
    Pass a smaller value only if you know the data fits (ValueError if not).
    """
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask).astype(bool)
    if receivers.shape != edge_mask.shape:
        raise ValueError(f"shape mismatch {receivers.shape} vs {edge_mask.shape}")
    cap = static_n_tiles(receivers.shape[0], n_atoms, block_n, block_e)
    if n_tiles is None:
        n_tiles = cap

    n_regions = -(-n_atoms // block_n)
    eid = np.nonzero(edge_mask)[0]
    r = receivers[eid].astype(np.int64)
    if np.any((r < 0) | (r >= n_atoms)):
        raise ValueError("valid edge receiver outside [0, n_atoms)")
    order = np.argsort(r, kind="stable")
    eid, r = eid[order], r[order]

    g = r // block_n                                     # atom window per edge
    cnt = np.bincount(g, minlength=n_regions)            # edges per window
    tiles_per = np.maximum(1, -(-cnt // block_e))        # tiles per window
    total = int(tiles_per.sum())
    if total > n_tiles:
        raise ValueError(f"blocking needs {total} tiles > n_tiles={n_tiles}")

    tile_off = np.zeros(n_regions, np.int64)
    np.cumsum(tiles_per[:-1], out=tile_off[1:])
    region_start = np.zeros(n_regions, np.int64)
    np.cumsum(cnt[:-1], out=region_start[1:])

    p = np.arange(eid.shape[0], dtype=np.int64) - region_start[g]
    flat = (tile_off[g] + p // block_e) * block_e + p % block_e

    perm = np.zeros(n_tiles * block_e, np.int64)
    valid = np.zeros(n_tiles * block_e, bool)
    local = np.zeros(n_tiles * block_e, np.int32)
    perm[flat] = eid
    valid[flat] = True
    local[flat] = (r - g * block_n).astype(np.int32)

    # padding tiles point at the trash rows [n_atoms, n_atoms + block_n) the
    # kernel wrapper's segment-add already discards — never at real atoms,
    # so a kernel that mishandled a fully-masked tile could not corrupt them
    tile_base = np.full(n_tiles, n_atoms, np.int32)
    tile_base[:total] = np.repeat(
        (np.arange(n_regions) * block_n).astype(np.int32), tiles_per
    )
    return EdgeBlocking(perm, valid, local, tile_base, block_n, block_e)


def blocking_to_batch(b: EdgeBlocking) -> Dict[str, np.ndarray]:
    """Flatten to the reserved batch keys (see module docstring)."""
    return {
        "blk_perm": b.perm.astype(np.int32),
        "blk_valid": b.valid,
        "blk_local": b.local_rcv,
        "blk_base": b.tile_base,
    }


def blocking_from_batch(batch) -> Optional[Dict]:
    """Extract the kernel-facing blocking arrays from a batch dict, or None.

    Returns ``{"perm", "valid", "local", "base"}`` — the runtime-array half
    of the contract; the static ``block_n`` comes from the model config.
    """
    if "blk_perm" not in batch:
        return None
    return {
        "perm": batch["blk_perm"],
        "valid": batch["blk_valid"],
        "local": batch["blk_local"],
        "base": batch["blk_base"],
    }
