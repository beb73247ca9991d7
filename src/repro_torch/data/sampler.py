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

Not ported: the elastic rescale (``_ElasticRescaleMixin``, ``with_ranks``,
``rescale`` and the remainder universe they pack); it comes with the
elastic trainer.  ``_universe_bins`` is the hook it will extend: here the
universe of every epoch is the whole dataset.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

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
    """Iteration shared by both samplers over ``bins_for_epoch``."""

    n_ranks: int

    sizes: np.ndarray

    def bins_for_epoch(self, epoch: int) -> List[List[int]]:
        raise NotImplementedError

    def _universe_bins(self, epoch: int, pack) -> List[List[int]]:
        """Pack this epoch's universe and return bins of global indices;
        ``pack(sizes) -> Bins`` runs the sampler's algorithm.  The universe
        is the whole dataset in every epoch (the JAX package's elastic
        remainder universe is not ported)."""
        return [list(b) for b in pack(self.sizes).bins]

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

    def bins_for_epoch(self, epoch: int) -> List[List[int]]:
        return self._universe_bins(
            epoch,
            lambda s: fixed_count_batches(
                s, self.graphs_per_batch, self.n_ranks,
                shuffle=True, seed=hash((self.seed, epoch)) % (2**31),
            ),
        )
