"""Shape-stable request batching: Algorithm 1 as the serving batcher.

Training already solved the problem an inference server has: deal
variable-size molecular graphs into bins whose *collated* shapes come from
a small fixed set, so every batch hits an already-compiled program.  This
module reuses ``core.binpack.create_balanced_batches`` (the paper's
Algorithm 1) to pack pending requests and then maps each packed bin onto
the smallest fitting :class:`~repro_torch.data.collate.BinShape` from a fixed
**bucket ladder**:

* the ladder is a handful of capacities (e.g. 64/256/1024 atoms), each a
  full ``BinShape`` sharing one blocking tile geometry — the jit cache is
  bounded by ``len(ladder)`` programs per engine, all warm-compiled at
  startup;
* packing runs at the *largest* bucket's capacity (best padding/balance),
  then each bin downgrades to the smallest bucket it fits — a wave of small
  molecules compiles nothing new and pays the small bucket's latency;
* bins are *budget-complete*: Algorithm 1 bounds nodes only, so a
  post-pass splits any bin that would overflow a bucket's edge or graph
  slots (serving must never drop a request the way training collation may
  drop a trailing graph).

Everything here is pure host-side numpy/python — it runs on the server's
batcher thread, the serving twin of the prefetch pipeline's collate work.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.binpack import create_balanced_batches
from repro_torch.data.blocking import DEFAULT_BLOCK_E, DEFAULT_BLOCK_N
from repro_torch.data.collate import BinShape

__all__ = [
    "bucket_ladder",
    "bucket_key",
    "select_bucket",
    "pack_requests",
    "RequestTooLarge",
]


class RequestTooLarge(ValueError):
    """A single graph exceeds the largest bucket's node or edge budget."""


def bucket_ladder(
    capacities: Sequence[int],
    *,
    edge_factor: int = 48,
    max_graphs: int | None = None,
    block_n: int = DEFAULT_BLOCK_N,
    block_e: int = DEFAULT_BLOCK_E,
) -> Tuple[BinShape, ...]:
    """Build the fixed bucket set, sorted ascending by capacity.

    Every bucket shares ``edge_factor`` and the blocking tile geometry so
    the model's static ``interaction_block_n`` matches all of them."""
    caps = sorted(set(int(c) for c in capacities))
    if not caps or caps[0] <= 0:
        raise ValueError(f"need positive bucket capacities, got {capacities}")
    return tuple(
        BinShape.for_capacity(
            c, edge_factor, max_graphs, block_n=block_n, block_e=block_e
        )
        for c in caps
    )


def bucket_key(shape: BinShape) -> str:
    """Stable human-readable id for telemetry / census dicts."""
    return f"n{shape.max_nodes}_e{shape.max_edges}_g{shape.max_graphs}"


def select_bucket(
    ladder: Sequence[BinShape], n_nodes: int, n_edges: int, n_graphs: int
) -> BinShape:
    """Smallest bucket whose node/edge/graph budgets all fit."""
    for b in ladder:
        if (
            n_nodes <= b.max_nodes
            and n_edges <= b.max_edges
            and n_graphs <= b.max_graphs
        ):
            return b
    raise RequestTooLarge(
        f"bin of {n_graphs} graphs ({n_nodes} nodes / {n_edges} edges) fits "
        f"no bucket (largest: {bucket_key(ladder[-1])})"
    )


def _fits(shape: BinShape, nodes: int, edges: int, graphs: int) -> bool:
    return (
        nodes <= shape.max_nodes
        and edges <= shape.max_edges
        and graphs <= shape.max_graphs
    )


def _split_for_budgets(
    items: Sequence[int],
    sizes: np.ndarray,
    edges: np.ndarray,
    shape: BinShape,
) -> List[List[int]]:
    """First-fit-decreasing (by edges) split of one over-budget bin into
    sub-bins respecting all three budgets of ``shape``.  Each item fits
    alone (the submit-time guard), so this always terminates."""
    order = sorted(items, key=lambda i: (-int(edges[i]), -int(sizes[i])))
    bins: List[List[int]] = []
    budgets: List[Tuple[int, int, int]] = []  # (nodes, edges, graphs) used
    for i in order:
        n, e = int(sizes[i]), int(edges[i])
        for j, (bn, be, bg) in enumerate(budgets):
            if _fits(shape, bn + n, be + e, bg + 1):
                bins[j].append(i)
                budgets[j] = (bn + n, be + e, bg + 1)
                break
        else:
            bins.append([i])
            budgets.append((n, e, 1))
    return bins


def pack_requests(
    sizes: Sequence[int],
    edges: Sequence[int],
    ladder: Sequence[BinShape],
) -> List[Tuple[List[int], BinShape]]:
    """Pack one wave of pending requests into shape-stable buckets.

    Args:
      sizes: per-request atom counts.
      edges: per-request directed edge counts.
      ladder: the fixed bucket set from :func:`bucket_ladder` (ascending).

    Returns ``[(request_indices, bucket), ...]`` covering every index
    exactly once.  Raises :class:`RequestTooLarge` for a request no bucket
    can hold even alone (callers reject those at submit time).
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    edges = np.asarray(edges, dtype=np.int64)
    if sizes.size == 0:
        return []
    largest = ladder[-1]
    for i in range(len(sizes)):
        if not _fits(largest, int(sizes[i]), int(edges[i]), 1):
            raise RequestTooLarge(
                f"request of {int(sizes[i])} atoms / {int(edges[i])} edges "
                f"exceeds the largest bucket {bucket_key(largest)}"
            )

    packed = create_balanced_batches(sizes, largest.max_nodes, n_ranks=1)
    out: List[Tuple[List[int], BinShape]] = []
    for b in packed.bins:
        if not b:
            continue  # Algorithm 1's rank-multiple padding: nothing to serve
        sub_bins = [b]
        n, e, g = int(sizes[b].sum()), int(edges[b].sum()), len(b)
        if not _fits(largest, n, e, g):
            # node budget held (Algorithm 1's capacity) but edges or graph
            # slots overflow the bucket: split rather than drop
            sub_bins = _split_for_budgets(b, sizes, edges, largest)
        for sb in sub_bins:
            bucket = select_bucket(
                ladder,
                int(sizes[sb].sum()),
                int(edges[sb].sum()),
                len(sb),
            )
            out.append((list(map(int, sb)), bucket))
    return out
