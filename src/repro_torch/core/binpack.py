"""Algorithm 1 (*Create-Balanced-Batches*) of the paper, copied from the JAX
package's ``core/binpack.py`` with the ``Bins`` container it returns.

Sort graphs descending, cyclically deal them into capacity-sorted bins, mark
bins full when the current item no longer fits, and *reactivate* full bins
when a non-full bin becomes more occupied than a full one (the adaptive bin
management of §3.2).  ``len(bins) % n_ranks == 0`` is guaranteed.

Pure numpy host code: the serving batcher packs each request wave with it,
and the training sampler each epoch.  Beside it, the PyG-style
fixed-graph-count baseline (:func:`fixed_count_batches`) the paper compares
against.  The other baselines and the balance metrics of the JAX module are
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["Bins", "create_balanced_batches", "fixed_count_batches"]


@dataclasses.dataclass
class Bins:
    """Result of a packing: ``bins[j]`` is a list of item indices."""

    bins: List[List[int]]
    sizes: Sequence[int]  # item sizes (vertex counts), indexable by item id
    capacity: int

    @property
    def n_bins(self) -> int:
        return len(self.bins)

    def loads(self) -> np.ndarray:
        s = np.asarray(self.sizes)
        return np.array([int(s[b].sum()) if len(b) else 0 for b in self.bins])


def create_balanced_batches(
    sizes: Sequence[int],
    capacity: int,
    n_ranks: int,
    *,
    _depth: int = 0,
) -> Bins:
    """The paper's iterative multi-objective bin packing (Algorithm 1).

    Args:
      sizes: per-graph vertex (token) counts.
      capacity: max total tokens per bin (``C``; paper uses 3072).
      n_ranks: number of GPUs ``G``; the bin count is padded up to a multiple.

    Returns: ``Bins`` with every item assigned exactly once.
    """
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    N = len(sizes_arr)
    if N == 0:
        return Bins([], sizes_arr, capacity)
    if int(sizes_arr.max()) > capacity:
        raise ValueError(
            f"graph of size {int(sizes_arr.max())} exceeds bin capacity {capacity}"
        )

    # Line 1: stable sort descending; I is the index mapping.
    order = np.argsort(-sizes_arr, kind="stable")

    # Lines 3-4: M = ceil(S / C / G) * G bins.
    S = int(sizes_arr.sum())
    M = int(np.ceil(S / capacity / n_ranks)) * n_ranks
    M = max(M, n_ranks)

    bins: List[List[int]] = [[] for _ in range(M)]
    cap = np.full(M, capacity, dtype=np.int64)  # remaining capacity c(B_j)
    active = list(range(M))  # indices into bins, the non-full pool
    full: List[int] = []

    p = 0
    while p < N and active:
        # Line 8: stable sort active bins by remaining capacity, descending.
        active.sort(key=lambda j: -int(cap[j]))
        newly_full: List[int] = []
        # Line 9: one pass over the active bins (cyclic deal).
        for j in active:
            if p >= N:
                break
            item = int(order[p])
            if cap[j] >= sizes_arr[item]:
                bins[j].append(item)
                cap[j] -= sizes_arr[item]
                p += 1
            else:
                newly_full.append(j)  # Line 17: mark full
        # Lines 18-19: retire full bins.
        if newly_full:
            nf = set(newly_full)
            active = [j for j in active if j not in nf]
            full.extend(newly_full)
        # Lines 20-22: adaptive reactivation — if any active bin now has
        # *less* remaining capacity than a full bin, the "full" marks were
        # premature for the smaller items still left; unmark all.
        if full and active and p < N:
            min_active_cap = min(int(cap[j]) for j in active)
            if any(int(cap[j]) > min_active_cap for j in full):
                active.extend(full)
                full = []
        if not newly_full and p < N and not active:
            break

    result = Bins(bins, sizes_arr, capacity)

    # Lines 23-25: recurse on the remainder (opens fresh bins).
    if p < N:
        rest_items = [int(order[q]) for q in range(p, N)]
        rest = create_balanced_batches(
            sizes_arr[rest_items], capacity, n_ranks, _depth=_depth + 1
        )
        for b in rest.bins:
            result.bins.append([rest_items[i] for i in b])

    # Keep the bin count a multiple of n_ranks (empty bins are legal padding;
    # they carry zero work and the collator emits all-padding batches).
    while len(result.bins) % n_ranks != 0:
        result.bins.append([])
    return result


def fixed_count_batches(
    sizes: Sequence[int],
    graphs_per_batch: int,
    n_ranks: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
) -> Bins:
    """PyG-style fixed-graph-count minibatching (paper baseline)."""
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    N = len(sizes_arr)
    idx = np.arange(N)
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(idx)
    bins = [
        list(map(int, idx[s : s + graphs_per_batch]))
        for s in range(0, N, graphs_per_batch)
    ]
    while len(bins) % n_ranks != 0:
        bins.append([])
    # capacity := max observed load (fixed-count has no capacity concept)
    loads = [int(sizes_arr[b].sum()) if b else 0 for b in bins]
    return Bins(bins, sizes_arr, max(loads) if loads else 0)
