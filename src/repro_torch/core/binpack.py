"""Multi-objective bin packing for molecular-graph minibatches: a copy of
the JAX package's ``core/binpack.py``.

* ``create_balanced_batches`` — Algorithm 1 (*Create-Balanced-Batches*) of
  the paper: sort graphs descending, cyclically deal them into
  capacity-sorted bins, mark bins full when the current item no longer
  fits, and *reactivate* full bins when a non-full bin becomes more
  occupied than a full one (the adaptive bin management of §3.2).
  ``len(bins) % n_ranks == 0`` is guaranteed.
* ``two_level_batches`` — the pod form: Algorithm 1 packs graphs into
  per-device bins at the full rank count (level 1), then each step's bins
  are dealt to nodes largest-first onto the lightest node (level 2);
  ``two_level_metrics`` reports the imbalance at both levels.
* ``fixed_count_batches`` — PyG-style fixed-graph-count minibatching (the
  paper's baseline, Observation 1).
* ``first_fit_decreasing`` / ``best_fit_decreasing`` — the classical
  heuristics the paper contrasts with in §3.2.
* ``balance_metrics`` — the padding, load spread and straggler ratio of
  Eq. 3-5 and Fig. 12, from the token-count proxy or from measured per-rank
  work (``measured_work=``, the engines' ``RankTelemetry``).

Pure numpy host code: the serving batcher packs each request wave with it,
the training samplers each epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "Bins",
    "TwoLevelBins",
    "create_balanced_batches",
    "two_level_batches",
    "fixed_count_batches",
    "first_fit_decreasing",
    "best_fit_decreasing",
    "balance_metrics",
    "two_level_metrics",
    "BalanceMetrics",
]


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

    def work(self, cost: Optional[Callable[[int], float]] = None) -> np.ndarray:
        """Per-bin computational work under a per-graph cost model.

        The paper's objectives (Eq. 4-5) weigh a graph by |V|^2 (dense-ish
        worst case); the default here is linear in tokens, callers pass
        ``cost=lambda v: v**2`` for the quadratic objective.
        """
        cost = cost or (lambda v: float(v))
        return np.array(
            [sum(cost(int(self.sizes[i])) for i in b) for b in self.bins]
        )


# ---------------------------------------------------------------------------
# Algorithm 1: Create-Balanced-Batches
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Two-level packing: graphs -> ranks (within a node), bins -> nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TwoLevelBins:
    """Pod-topology packing: ``n_nodes`` hosts x ``ranks_per_node`` devices.

    ``flat.bins`` is ordered **step-major, node-major**: the bin consumed by
    step ``s``, node ``n``, local device ``d`` is
    ``flat.bins[(s * n_nodes + n) * ranks_per_node + d]`` — exactly the
    flattening order of a ``("node", "device")`` mesh's data axis, so the
    stacked ``[R, ...]`` batch shards onto the 2D mesh with one bin per
    device and each node's ``ranks_per_node`` bins contiguous.
    """

    flat: Bins
    n_nodes: int
    ranks_per_node: int

    @property
    def n_ranks(self) -> int:
        return self.n_nodes * self.ranks_per_node

    @property
    def n_steps(self) -> int:
        return self.flat.n_bins // self.n_ranks

    def rank_loads(self) -> np.ndarray:
        """[steps, n_nodes * ranks_per_node] tokens per device bin."""
        return self.flat.loads().reshape(self.n_steps, self.n_ranks)

    def node_loads(self) -> np.ndarray:
        """[steps, n_nodes] tokens per node (sum over its local devices) —
        the load the *inter-node* collective waits on each step."""
        return self.rank_loads().reshape(
            self.n_steps, self.n_nodes, self.ranks_per_node
        ).sum(axis=2)

    def node_bins(self) -> Bins:
        """Node-granularity view: one merged bin per (step, node), capacity
        scaled by ``ranks_per_node`` — feed to :func:`balance_metrics` for
        the node-level numbers."""
        merged = []
        rpn = self.ranks_per_node
        for g in range(self.flat.n_bins // rpn):
            merged.append(
                [i for b in self.flat.bins[g * rpn : (g + 1) * rpn] for i in b]
            )
        return Bins(merged, self.flat.sizes, self.flat.capacity * rpn)


def two_level_batches(
    sizes: Sequence[int],
    capacity: int,
    n_nodes: int,
    ranks_per_node: int,
) -> TwoLevelBins:
    """Two-level Algorithm-1 packing for a ``("node", "device")`` mesh.

    Level 1 (graphs -> ranks): :func:`create_balanced_batches` packs graphs
    into per-device bins at the full rank count, so every device bin obeys
    the capacity budget and per-step bins are token-balanced.

    Level 2 (bins -> nodes): within each step group of ``n_nodes *
    ranks_per_node`` bins, bins are dealt to nodes LPT-style (largest bin
    to the currently lightest node with a free slot).  Level 1 balances the
    *device* straggler; level 2 additionally balances the *node* totals the
    slow inter-node hop waits on — residual bin-load spread pairs a node's
    heavy bin with light ones instead of landing on whichever node the flat
    order put it.
    """
    if n_nodes < 1 or ranks_per_node < 1:
        raise ValueError(
            f"need n_nodes >= 1 and ranks_per_node >= 1, got "
            f"({n_nodes}, {ranks_per_node})"
        )
    n_ranks = n_nodes * ranks_per_node
    level1 = create_balanced_batches(sizes, capacity, n_ranks)
    if n_nodes == 1:
        # Nothing for level 2 to balance — keep level 1's bin order so the
        # single-node pod is bit-identical to the flat packing.
        return TwoLevelBins(level1, n_nodes, ranks_per_node)
    loads = level1.loads()
    out: List[List[int]] = []
    for s in range(level1.n_bins // n_ranks):
        grp = list(range(s * n_ranks, (s + 1) * n_ranks))
        # LPT deal: heaviest bin first, to the lightest node with room
        order = sorted(grp, key=lambda j: (-int(loads[j]), j))
        node_tot = np.zeros(n_nodes, dtype=np.int64)
        node_members: List[List[int]] = [[] for _ in range(n_nodes)]
        for j in order:
            open_nodes = [
                n for n in range(n_nodes)
                if len(node_members[n]) < ranks_per_node
            ]
            tgt = min(open_nodes, key=lambda n: (int(node_tot[n]), n))
            node_members[tgt].append(j)
            node_tot[tgt] += int(loads[j])
        for members in node_members:
            out.extend(level1.bins[j] for j in members)
    return TwoLevelBins(
        Bins(out, level1.sizes, capacity), n_nodes, ranks_per_node
    )


def two_level_metrics(
    tl: TwoLevelBins,
    *,
    measured_rank_work: Optional[np.ndarray] = None,
) -> Dict[str, BalanceMetrics]:
    """Per-level imbalance report for a two-level packing.

    ``"rank"`` is the device-level view (level 1: per-bin loads against the
    full rank count) and ``"node"`` the host-level view (level 2: per-node
    token totals against ``n_nodes`` — what the inter-node all-reduce
    straggles on).  ``measured_rank_work`` — an optional
    ``[steps, n_ranks]`` matrix from engine telemetry — replaces the
    token-count proxy at both levels (node work = sum over the node's
    device columns), mirroring :func:`balance_metrics`.
    """
    rank_work = None
    node_work = None
    if measured_rank_work is not None:
        rank_work = np.asarray(measured_rank_work, dtype=np.float64)
        if rank_work.ndim != 2 or rank_work.shape[1] != tl.n_ranks:
            raise ValueError(
                f"measured_rank_work must be [steps, {tl.n_ranks}], "
                f"got {rank_work.shape}"
            )
        node_work = rank_work.reshape(
            rank_work.shape[0], tl.n_nodes, tl.ranks_per_node
        ).sum(axis=2)
    return {
        "rank": balance_metrics(
            tl.flat, tl.n_ranks, measured_work=rank_work
        ),
        "node": balance_metrics(
            tl.node_bins(), tl.n_nodes, measured_work=node_work
        ),
    }


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


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


def first_fit_decreasing(
    sizes: Sequence[int], capacity: int, n_ranks: int
) -> Bins:
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    order = np.argsort(-sizes_arr, kind="stable")
    bins: List[List[int]] = []
    caps: List[int] = []
    for i in map(int, order):
        placed = False
        for j in range(len(bins)):
            if caps[j] >= sizes_arr[i]:
                bins[j].append(i)
                caps[j] -= int(sizes_arr[i])
                placed = True
                break
        if not placed:
            bins.append([i])
            caps.append(capacity - int(sizes_arr[i]))
    while len(bins) % n_ranks != 0:
        bins.append([])
    return Bins(bins, sizes_arr, capacity)


def best_fit_decreasing(
    sizes: Sequence[int], capacity: int, n_ranks: int
) -> Bins:
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    order = np.argsort(-sizes_arr, kind="stable")
    bins: List[List[int]] = []
    caps: List[int] = []
    for i in map(int, order):
        best, best_rem = -1, capacity + 1
        for j in range(len(bins)):
            rem = caps[j] - int(sizes_arr[i])
            if 0 <= rem < best_rem:
                best, best_rem = j, rem
        if best < 0:
            bins.append([i])
            caps.append(capacity - int(sizes_arr[i]))
        else:
            bins[best].append(i)
            caps[best] = best_rem
    while len(bins) % n_ranks != 0:
        bins.append([])
    return Bins(bins, sizes_arr, capacity)


# ---------------------------------------------------------------------------
# Metrics (Eq. 3-5 objectives + Fig. 12 quantities)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BalanceMetrics:
    n_bins: int
    mean_load: float
    max_load: int
    min_load: int
    load_cv: float              # coefficient of variation of bin loads
    max_pairwise_gap: int       # Eq. 5 (linear-cost version)
    padding_fraction: float     # Eq. 4: unused capacity / total capacity
    straggler_ratio: float      # max rank work / mean rank work (per-step max, averaged)
    measured: bool = False      # straggler_ratio from engine telemetry (per-rank
                                # wall times, or observed per-rank loads for
                                # lock-step engines) instead of the packing model

    def row(self) -> str:
        return (
            f"bins={self.n_bins} load(mean/max/min)={self.mean_load:.0f}/"
            f"{self.max_load}/{self.min_load} cv={self.load_cv:.3f} "
            f"gap={self.max_pairwise_gap} pad={self.padding_fraction:.3f} "
            f"straggler={self.straggler_ratio:.3f}"
        )


def balance_metrics(
    b: Bins, n_ranks: int, *, measured_work: Optional[np.ndarray] = None
) -> BalanceMetrics:
    """Balance/padding metrics for a packing.

    ``measured_work`` — an optional ``[steps, n_ranks]`` matrix of *measured*
    per-rank work (wall seconds from ``train.engine.RankTelemetry
    .work_matrix()``).  When given, the straggler ratio is computed from the
    measurements instead of the token-count proxy, closing the loop between
    the engine's telemetry and the scaling model.
    """
    loads = b.loads()
    nonempty = loads[loads > 0] if (loads > 0).any() else loads
    cap = max(b.capacity, 1)
    # a packing can legitimately be empty (e.g. the remainder of an epoch
    # rescaled away at its last step): degrade to neutral metrics
    pad = float((cap - nonempty).clip(min=0).sum()) / max(len(nonempty) * cap, 1)

    if measured_work is not None:
        work = np.asarray(measured_work, dtype=np.float64)
        if work.ndim != 2 or work.shape[1] != n_ranks:
            raise ValueError(
                f"measured_work must be [steps, {n_ranks}], got {work.shape}"
            )
        steps = work.shape[0]
    else:
        # Straggler model: bins are consumed round-robin across ranks; each
        # step takes the max rank work; ratio vs. perfectly balanced.
        steps = len(loads) // n_ranks
        work = (
            loads[: steps * n_ranks].reshape(steps, n_ranks)
            if steps
            else loads.reshape(0, n_ranks)
        )
    per_step_max = work.max(axis=1) if steps else np.array([0.0])
    per_step_mean = np.maximum(work.mean(axis=1), 1e-9) if steps else np.array([1.0])
    straggler = float(np.mean(per_step_max / per_step_mean)) if steps else 1.0

    return BalanceMetrics(
        n_bins=int(b.n_bins),
        mean_load=float(loads.mean()) if len(loads) else 0.0,
        max_load=int(loads.max()) if len(loads) else 0,
        min_load=int(nonempty.min()) if len(nonempty) else 0,
        load_cv=float(loads.std() / max(loads.mean(), 1e-9)) if len(loads) else 0.0,
        max_pairwise_gap=int(loads.max() - loads.min()) if len(loads) else 0,
        padding_fraction=pad,
        straggler_ratio=straggler,
        measured=measured_work is not None,
    )


def assignment_vector(b: Bins, n_items: int) -> np.ndarray:
    """item -> bin map; -1 if unassigned (never, by construction)."""
    out = np.full(n_items, -1, dtype=np.int64)
    for j, items in enumerate(b.bins):
        for i in items:
            out[i] = j
    return out
