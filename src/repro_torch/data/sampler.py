"""Epoch samplers: the paper's balanced batch sampler vs. fixed-count.

Copy of the JAX package's ``data/sampler.py`` at a fixed rank count.
``BalancedBatchSampler`` packs each epoch with Algorithm 1 (every rank
process derives the *same* bins: stable sorting makes the packing
deterministic) and takes one bin per rank per step; epoch-seeded bin
shuffling permutes steps and rotates the rank assignment without
disturbing per-step balance.  ``HierarchicalBalancedSampler`` packs with
the two-level Algorithm 1 for ``n_nodes`` x ``ranks_per_node`` ranks in
node-major order and rotates by whole nodes.  ``SamplerState`` (epoch,
cursor) is the resumable state a checkpoint stores, and ``step_iter``
snapshots it eagerly so the prefetch producer can run ahead while the live
state advances.

Elastic rescale: ``with_ranks`` re-packs for a new rank count (the bins are
independent, so scaling up or down is a pure host-side operation), and
``rescale`` performs the *mid-epoch* cursor remap.  ``SamplerState.cursor``
counts steps at the sampler's own rank count, so ``rescale(R_new, state)``
treats the first ``cursor * R_old`` bins of the epoch's packing as the
consumed prefix, re-packs the remaining graph indices with the sampler's
algorithm at ``R_new`` (an epoch-scoped *remainder universe*) and restarts
at ``cursor=0`` inside that packing.  Consumed prefix + remainder stream ==
every index exactly once, and that composes: a chain ``R0 -> R1 -> ... ->
Rk`` within one epoch still covers the dataset exactly once.  The remainder
universe applies only to the epoch it was made in; the next epoch packs the
full dataset at the new rank count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.binpack import (
    create_balanced_batches,
    fixed_count_batches,
    two_level_batches,
)


@dataclasses.dataclass
class SamplerState:
    epoch: int
    cursor: int  # steps consumed in this epoch (per rank)

    def to_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "SamplerState":
        return SamplerState(int(d["epoch"]), int(d["cursor"]))


def _step_slices(
    bins: List[List[int]], n_ranks: int, cursor: int
) -> List[List[List[int]]]:
    """Materialised per-step rank groups starting at the resume cursor."""
    n_steps = len(bins) // n_ranks
    return [
        bins[step * n_ranks : (step + 1) * n_ranks]
        for step in range(cursor, n_steps)
    ]


class _EpochSampler:
    """Iteration and elastic rescale shared by the samplers over
    ``bins_for_epoch``.

    ``_resume`` is ``None`` for a full-dataset packing, or ``(epoch,
    remaining_indices)``: this sampler's packing for ``epoch`` covers
    exactly ``remaining_indices`` (the graphs a pre-rescale sampler had not
    yet consumed).  Any other epoch packs the full dataset.
    """

    n_ranks: int

    sizes: np.ndarray

    _resume: Optional[Tuple[int, Tuple[int, ...]]] = None

    def bins_for_epoch(self, epoch: int) -> List[List[int]]:
        raise NotImplementedError

    def with_ranks(self, n_ranks: int) -> "_EpochSampler":
        raise NotImplementedError

    def _epoch_universe(self, epoch: int) -> Optional[np.ndarray]:
        """Global indices this epoch's packing draws from (None = all)."""
        if self._resume is not None and self._resume[0] == epoch:
            return np.asarray(self._resume[1], np.int64)
        return None

    def _universe_bins(self, epoch: int, pack) -> List[List[int]]:
        """Pack this epoch's universe and return bins of *global* indices.

        ``pack(sizes) -> Bins`` runs the sampler's packing algorithm; when
        the epoch is a rescale remainder, it packs the remaining sizes and
        the local bin entries are mapped back through the universe."""
        sub = self._epoch_universe(epoch)
        if sub is None:
            return [list(b) for b in pack(self.sizes).bins]
        return [[int(sub[i]) for i in b] for b in pack(self.sizes[sub]).bins]

    def consumed_indices(self, state: SamplerState) -> List[int]:
        """Graph indices consumed by the first ``state.cursor`` steps of
        ``state.epoch``: the prefix a rescale treats as done."""
        bins = self.bins_for_epoch(state.epoch)
        prefix = bins[: state.cursor * self.n_ranks]
        return sorted(i for b in prefix for i in b)

    def rescale(
        self, n_ranks: int, state: SamplerState
    ) -> Tuple["_EpochSampler", SamplerState]:
        """Mid-epoch elastic rescale: cursor remap by remainder re-packing.

        Returns ``(sampler, state)`` where the new sampler's packing for
        ``state.epoch`` covers exactly the graphs this sampler had *not*
        consumed after ``state.cursor`` steps, re-packed at ``n_ranks``, and
        the new state restarts at ``cursor=0`` inside it.  Later epochs pack
        the full dataset at ``n_ranks``.
        """
        new = self.with_ranks(n_ranks)
        if state.cursor <= 0:
            # nothing of *this* packing consumed; inherit its universe
            # (it may itself be a remainder from an earlier rescale)
            new._resume = self._resume
            return new, SamplerState(state.epoch, 0)
        consumed = set(self.consumed_indices(state))
        universe = self._epoch_universe(state.epoch)
        if universe is None:
            universe = np.arange(len(self.sizes), dtype=np.int64)
        remaining = tuple(int(i) for i in universe if int(i) not in consumed)
        new._resume = (state.epoch, remaining)
        return new, SamplerState(state.epoch, 0)

    def steps_per_epoch(self, epoch: int = 0) -> int:
        return len(self.bins_for_epoch(epoch)) // self.n_ranks

    def epoch_iter(self, rank: int, state: SamplerState) -> Iterator[List[int]]:
        """Yield this rank's bins for ``state.epoch``, starting at the cursor
        (checkpoint resume lands mid-epoch without replaying)."""
        bins = self.bins_for_epoch(state.epoch)
        n_steps = len(bins) // self.n_ranks
        for step in range(state.cursor, n_steps):
            yield bins[step * self.n_ranks + rank]

    def step_iter(self, state: SamplerState) -> Iterator[List[List[int]]]:
        """One bin *per rank* per step, ``[bin_rank0, ..., bin_rankR-1]``,
        from the resume cursor.  Prefetch-safe: ``(epoch, cursor)`` is
        snapshotted eagerly and the iterator walks a precomputed index list,
        so a producer thread can run ahead while the loop mutates the live
        ``SamplerState``."""
        return iter(_step_slices(self.bins_for_epoch(state.epoch),
                                 self.n_ranks, state.cursor))


class BalancedBatchSampler(_EpochSampler):
    def __init__(
        self,
        sizes: Sequence[int],
        capacity: int,
        n_ranks: int,
        seed: int = 0,
        shuffle_bins: bool = True,
    ):
        self.sizes = np.asarray(sizes, np.int64)
        self.capacity = capacity
        self.n_ranks = n_ranks
        self.seed = seed
        self.shuffle_bins = shuffle_bins
        self._cache_epoch: Optional[int] = None
        self._cache: Optional[List[List[int]]] = None

    def with_ranks(self, n_ranks: int) -> "BalancedBatchSampler":
        """Elastic rescale at an epoch boundary: same data, new rank count,
        full-dataset packing (mid-epoch, use :meth:`rescale`)."""
        return BalancedBatchSampler(
            self.sizes, self.capacity, n_ranks, self.seed, self.shuffle_bins
        )

    def bins_for_epoch(self, epoch: int) -> List[List[int]]:
        if self._cache_epoch == epoch and self._cache is not None:
            return self._cache
        bins = self._universe_bins(
            epoch,
            lambda s: create_balanced_batches(s, self.capacity, self.n_ranks),
        )
        if self.shuffle_bins:
            rng = np.random.default_rng((self.seed, epoch))
            # permute bins in rank-sized groups so each step keeps one bin per
            # rank from the same balance neighbourhood (adjacent bins have the
            # most similar load by construction).
            n_steps = len(bins) // self.n_ranks
            order = rng.permutation(n_steps)
            regrouped: List[List[int]] = []
            for s in order:
                grp = bins[s * self.n_ranks : (s + 1) * self.n_ranks]
                rot = int(rng.integers(self.n_ranks))
                regrouped.extend(grp[rot:] + grp[:rot])
            bins = regrouped
        self._cache_epoch, self._cache = epoch, bins
        return bins


class HierarchicalBalancedSampler(BalancedBatchSampler):
    """Two-level balanced sampler for ``n_nodes`` x ``ranks_per_node``
    ranks.

    Same contract as :class:`BalancedBatchSampler` with ``n_ranks ==
    n_nodes * ranks_per_node``, but each epoch's packing is
    ``binpack.two_level_batches``: graphs -> per-device bins (level 1,
    Algorithm 1), then bins -> nodes (level 2, LPT within every step
    group).  The per-step rank order is **node-major** — rank ``r`` is node
    ``r // ranks_per_node``, local device ``r % ranks_per_node`` — the rank
    order of ``launch.mesh.make_node_device_groups``, so ``step_iter``
    feeds the multi-host engine directly.

    Epoch shuffling keeps both levels intact: step groups are permuted and
    rank assignment rotated by *whole nodes* (a raw bin rotation would tear
    a node's LPT group apart and undo the level-2 balance).

    Elastic topology: ``with_ranks(R)`` keeps ``ranks_per_node`` when ``R``
    divides by it (losing a host is ``n_nodes -> n_nodes - 1``) and
    degrades to a flat single-level packing otherwise, so the rescale remap
    chain composes across topology changes.
    """

    def __init__(
        self,
        sizes: Sequence[int],
        capacity: int,
        n_nodes: int,
        ranks_per_node: int,
        seed: int = 0,
        shuffle_bins: bool = True,
    ):
        super().__init__(
            sizes, capacity, n_nodes * ranks_per_node, seed, shuffle_bins
        )
        self.n_nodes = n_nodes
        self.ranks_per_node = ranks_per_node

    def with_ranks(self, n_ranks: int) -> "BalancedBatchSampler":
        """Rescale to ``n_ranks`` ranks: hierarchical again when the node
        width divides it, else a flat packing (documented degrade)."""
        if n_ranks % self.ranks_per_node == 0:
            return HierarchicalBalancedSampler(
                self.sizes, self.capacity, n_ranks // self.ranks_per_node,
                self.ranks_per_node, self.seed, self.shuffle_bins,
            )
        return BalancedBatchSampler(
            self.sizes, self.capacity, n_ranks, self.seed, self.shuffle_bins
        )

    def bins_for_epoch(self, epoch: int) -> List[List[int]]:
        if self._cache_epoch == epoch and self._cache is not None:
            return self._cache
        bins = self._universe_bins(
            epoch,
            lambda s: two_level_batches(
                s, self.capacity, self.n_nodes, self.ranks_per_node
            ).flat,
        )
        if self.shuffle_bins:
            rng = np.random.default_rng((self.seed, epoch))
            n_steps = len(bins) // self.n_ranks
            order = rng.permutation(n_steps)
            regrouped: List[List[int]] = []
            for s in order:
                grp = bins[s * self.n_ranks : (s + 1) * self.n_ranks]
                # rotate by whole nodes only: node groups stay contiguous
                rot = int(rng.integers(self.n_nodes)) * self.ranks_per_node
                regrouped.extend(grp[rot:] + grp[:rot])
            bins = regrouped
        self._cache_epoch, self._cache = epoch, bins
        return bins


class FixedCountSampler(_EpochSampler):
    """PyG-style baseline: fixed number of graphs per minibatch."""

    def __init__(
        self, sizes: Sequence[int], graphs_per_batch: int, n_ranks: int, seed: int = 0
    ):
        self.sizes = np.asarray(sizes, np.int64)
        self.graphs_per_batch = graphs_per_batch
        self.n_ranks = n_ranks
        self.seed = seed

    def with_ranks(self, n_ranks: int) -> "FixedCountSampler":
        """Elastic rescale at an epoch boundary (mid-epoch: `rescale`)."""
        return FixedCountSampler(
            self.sizes, self.graphs_per_batch, n_ranks, self.seed
        )

    def bins_for_epoch(self, epoch: int) -> List[List[int]]:
        return self._universe_bins(
            epoch,
            lambda s: fixed_count_batches(
                s, self.graphs_per_batch, self.n_ranks,
                shuffle=True, seed=hash((self.seed, epoch)) % (2**31),
            ),
        )
