"""Execution engines: one step API, a sequential oracle and two
data-parallel backends on ``torch.distributed``.

Port of the JAX package's ``train/engine.py``:

    engine.collate(mols_per_rank, bin_shape)
              -> (numpy batches of this process's ranks, host stats {"block_s": s})
    engine.to_device(batches)                -> the batches on the device
    engine.init_ef(params)                   -> error-feedback residuals
    engine.step(params, opt_state, ef, batches, step)
                                    -> (params, opt_state, ef, metrics)
    engine.close()                           -> teardown

``collate`` is numpy only, so it may run on the prefetch producer thread;
``to_device`` and ``step`` run on the trainer's thread.  ``step`` takes the
weighted loss and its parameter gradients once per bin (the forces term
makes that a grad-of-grad), averages the gradients over the ranks, and
applies one optimizer update.  Engines are context managers.

``SequentialEngine``
    The oracle: one process loops over R logical ranks and combines their
    gradients as the all-reduce would: the mean, or, with
    ``compress_grads``, the shared-scale int8 sum with rank-local error
    feedback (``_emulated_compressed_mean_ef``), or with ``n_nodes`` set
    the hierarchical form (``_emulated_hier_compressed_mean``: the mean
    inside each node, int8 error feedback across nodes, residuals per
    node).  The JAX engines' tests hold them to this oracle; the port's
    tests hold this oracle to the JAX one.

``DataParallelEngine`` (the JAX ``ShardMapEngine``)
    One process per rank, on a flat group (``launch.mesh.make_dp_group``).
    Each process collates only its own bin (``local_rank_range``), takes
    its gradients, and averages them: one flat buffer, ``all_reduce(SUM) /
    R``, or ``compression.compressed_allreduce_ef`` per tensor when
    compressing.  Metrics are averaged the same way.  Parameters and
    optimizer state are replicated (the same seed, the same reduced
    gradients, the same update on every rank); the residual is this rank's
    ``[1, ...]`` row of the JAX engine's ``[R, ...]`` stack.

``MultiHostEngine``
    One process per rank in an ``n_nodes`` x ``devices_per_node`` grid
    (``launch.mesh.make_node_device_groups``, node-major).  Gradients are
    averaged over the node's ``device`` group (the fast links: no
    quantisation), then over the ``node`` group: the plain mean or
    ``compressed_allreduce_ef`` with ``group_size=n_nodes`` (the identity
    for one node).  The residual is per node (``[1, ...]``, the same on
    every device of a node, as the JAX engine's ``P("node")`` shard), since
    every device of a node quantises the same post-mean gradient.

Several rank processes can share one card: their group's backend is then
gloo, and ``compression.all_reduce_`` stages the flat CUDA buffer through
host memory (one copy each way).  :class:`RankTelemetry` holds measured
per-rank times of each bin's forward and backward.  The sequential engine
times each bin with CUDA events and its real atoms come from the host
arrays, so the step never waits on the device for them: ``settle()``
records the step once its metrics have been read, which waits for that
work anyway.  The distributed engines read each rank's time after
``torch.cuda.synchronize``, since they ``all_gather`` each rank's time
and load within the step so that every process holds the ``[R]`` rows.
An elastic rescale (``train_loop.Trainer.rescale``)
closes the engine and builds another: its telemetry records the event's
seconds (``record_rescale``), and ``RankTelemetry.merged`` reads every
generation of a run as one.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.bridge import flatten, unflatten
from repro_torch.core.mace import MaceConfig, interaction_consumes_blocking, weighted_loss
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.kernels import autotune
from repro_torch.launch.mesh import make_dp_group, make_node_device_groups

from .compression import all_reduce_, compressed_allreduce_ef
from .optimizer import Transform, apply_updates, tree_map

Batch = Dict[str, torch.Tensor]


class DeviceBatch(dict):
    """One bin's arrays on the device (``to_device``), with its real atoms
    as the host counted them from the collated ``node_mask``."""

    real_atoms: float = 0.0


class _BinTimer:
    """The seconds of one bin's forward and backward: between two CUDA
    events on the card, read once the device has passed the second; the
    host clock on the CPU, where the work is done when the call returns."""

    def __init__(self, device: torch.device):
        self.events = None
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
            self.stream = stream
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.events is None:
            self.t1 = time.perf_counter()
        else:
            self.events[1].record(self.stream)

    def seconds(self) -> float:
        if self.events is None:
            return self.t1 - self.t0
        start, end = self.events
        end.synchronize()  # passed already once the step's metrics were read
        return start.elapsed_time(end) / 1e3


@dataclasses.dataclass
class RankTelemetry:
    """Per-step, per-rank measurements accumulated over a run.  Summary
    methods take ``skip``: pass ``skip=1`` to drop the first step (kernel
    loads and first-touch allocations)."""

    n_ranks: int
    times: List[List[float]] = dataclasses.field(default_factory=list)
    loads: List[List[float]] = dataclasses.field(default_factory=list)
    # host-side prefetch telemetry (one scalar per step)
    host_collate: List[float] = dataclasses.field(default_factory=list)
    host_wait: List[float] = dataclasses.field(default_factory=list)
    # seconds of ``collate_s`` spent building the edge blocking
    host_block: List[float] = dataclasses.field(default_factory=list)
    # elastic rescale events the trainer folded into this engine's run: per
    # event, host seconds re-packing bins (Algorithm 1 on the epoch
    # remainder) and seconds tearing down and rebuilding the engine
    rescale_repack: List[float] = dataclasses.field(default_factory=list)
    rescale_rebuild: List[float] = dataclasses.field(default_factory=list)

    def record(self, times: Sequence[float], loads: Sequence[float]) -> None:
        if len(times) != self.n_ranks or len(loads) != self.n_ranks:
            raise ValueError(f"expected {self.n_ranks} per-rank times and loads")
        self.times.append([float(t) for t in times])
        self.loads.append([float(x) for x in loads])

    def record_host(
        self, collate_s: float, wait_s: float, block_s: float = 0.0
    ) -> None:
        """Per-step host timings from the prefetch pipeline: seconds spent
        collating the batch, seconds the step loop blocked waiting for it,
        and the part of the collate seconds spent on edge blocking."""
        self.host_collate.append(float(collate_s))
        self.host_wait.append(float(wait_s))
        self.host_block.append(float(block_s))

    def record_rescale(self, repack_s: float, rebuild_s: float) -> None:
        """One elastic rescale event: bin re-pack seconds and engine
        rebuild seconds."""
        self.rescale_repack.append(float(repack_s))
        self.rescale_rebuild.append(float(rebuild_s))

    def rescale_seconds(self) -> Tuple[float, float]:
        """(total repack seconds, total engine-rebuild seconds)."""
        return float(np.sum(self.rescale_repack)), float(np.sum(self.rescale_rebuild))

    @property
    def n_steps(self) -> int:
        return len(self.times)

    def work_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, ranks] wall seconds."""
        return np.asarray(self.times[skip:], dtype=np.float64).reshape(-1, self.n_ranks)

    def load_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, ranks] real atoms per bin."""
        return np.asarray(self.loads[skip:], dtype=np.float64).reshape(-1, self.n_ranks)

    def straggler_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, ranks] per-rank work for the straggler model: every
        engine of the port times each rank on its own, so these are the
        measured times.  Feed to ``binpack.balance_metrics(measured_work=...)``."""
        return self.work_matrix(skip)

    def c_token(self, skip: int = 0) -> float:
        """Calibrated per-atom step cost (seconds/atom)."""
        t, loads = self.work_matrix(skip), self.load_matrix(skip)
        if t.size == 0:
            return 0.0
        return float(t.sum()) / max(float(loads.sum()), 1.0)

    def measured_straggler(self, skip: int = 0) -> float:
        """Mean over steps of (max rank time / mean rank time)."""
        w = self.straggler_matrix(skip)
        if w.size == 0:
            return 1.0
        return float(np.mean(w.max(axis=1) / np.maximum(w.mean(axis=1), 1e-12)))

    def host_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, 2] host seconds per step: (collate_s, wait_s)."""
        if not self.host_collate[skip:]:
            return np.zeros((0, 2))
        return np.stack([np.asarray(self.host_collate[skip:], np.float64),
                         np.asarray(self.host_wait[skip:], np.float64)], axis=1)

    def overlap_seconds(self, skip: int = 0) -> float:
        """Collate seconds hidden behind device compute: per step
        ``max(collate_s - wait_s, 0)``, summed."""
        h = self.host_matrix(skip)
        return float(np.maximum(h[:, 0] - h[:, 1], 0.0).sum())

    def overlap_fraction(self, skip: int = 0) -> float:
        total = float(self.host_matrix(skip)[:, 0].sum())
        return self.overlap_seconds(skip) / total if total > 0 else 0.0

    def blocking_seconds(self, skip: int = 0) -> float:
        return float(np.sum(self.host_block[skip:]))

    @classmethod
    def merged(cls, *generations: "RankTelemetry") -> "MergedTelemetry":
        """One view over the telemetry of several engine *generations* (one
        per elastic-rescale segment, oldest first).  Rank counts may differ,
        so the per-generation matrices stay apart while every scalar
        summary aggregates over the whole run; ``skip`` applies per
        generation (each rebuilt engine pays its first step again)."""
        if not generations:
            raise ValueError("merged() needs at least one generation")
        return MergedTelemetry(tuple(generations))


@dataclasses.dataclass(frozen=True)
class MergedTelemetry:
    """Read-only aggregate over ``RankTelemetry`` generations (see
    ``RankTelemetry.merged``): the same summaries, minus the single-matrix
    accessors (rank counts differ across generations)."""

    generations: Tuple[RankTelemetry, ...]

    @property
    def n_generations(self) -> int:
        return len(self.generations)

    @property
    def n_steps(self) -> int:
        return sum(g.n_steps for g in self.generations)

    def work_matrices(self, skip: int = 0) -> List[np.ndarray]:
        """One [steps, ranks] wall-seconds matrix per generation."""
        return [g.work_matrix(skip) for g in self.generations]

    def load_matrices(self, skip: int = 0) -> List[np.ndarray]:
        return [g.load_matrix(skip) for g in self.generations]

    def straggler_matrices(self, skip: int = 0) -> List[np.ndarray]:
        return [g.straggler_matrix(skip) for g in self.generations]

    def c_token(self, skip: int = 0) -> float:
        """Whole-run seconds per atom: the generations' sums are added
        before dividing, so long generations weigh proportionally."""
        num = sum(float(t.sum()) for t in self.work_matrices(skip))
        den = sum(float(x.sum()) for x in self.load_matrices(skip))
        return num / max(den, 1.0) if num else 0.0

    def measured_straggler(self, skip: int = 0) -> float:
        """Step-weighted mean over generations of max/mean rank time."""
        per_step = [w.max(axis=1) / np.maximum(w.mean(axis=1), 1e-12)
                    for w in self.straggler_matrices(skip) if w.size]
        return float(np.mean(np.concatenate(per_step))) if per_step else 1.0

    def host_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, 2] (collate_s, wait_s), concatenated across generations."""
        mats = [m for m in (g.host_matrix(skip) for g in self.generations) if m.size]
        return np.concatenate(mats, axis=0) if mats else np.zeros((0, 2))

    def overlap_seconds(self, skip: int = 0) -> float:
        return float(sum(g.overlap_seconds(skip) for g in self.generations))

    def overlap_fraction(self, skip: int = 0) -> float:
        h = self.host_matrix(skip)
        total = float(h[:, 0].sum()) if h.size else 0.0
        return self.overlap_seconds(skip) / total if total > 0 else 0.0

    def blocking_seconds(self, skip: int = 0) -> float:
        return float(sum(g.blocking_seconds(skip) for g in self.generations))

    def rescale_seconds(self) -> Tuple[float, float]:
        """(total repack seconds, total engine-rebuild seconds)."""
        rs = [g.rescale_seconds() for g in self.generations]
        return float(sum(r for r, _ in rs)), float(sum(b for _, b in rs))


def make_loss_fn(mace_cfg: MaceConfig, tcfg, n_graphs: int) -> Callable:
    def loss_fn(params, batch):
        return weighted_loss(
            params, mace_cfg, batch, n_graphs,
            tcfg.energy_weight, tcfg.forces_weight,
        )

    return loss_fn


def _emulated_compressed_mean_ef(stacked_g, stacked_e):
    """One-process twin of ``compression.compressed_allreduce_ef`` on a
    gradient and its residuals stacked ``[R, ...]``: per-rank residual
    added, shared max scale, int8-quantised per-rank payloads, integer sum,
    dequantise / R, new residuals kept per rank.  Returns ``(g_hat_mean,
    new_stacked_e)``."""
    R = stacked_g.shape[0]
    c = stacked_g.to(torch.float32) + stacked_e
    scale = c.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(c / scale), -127, 127)
    total = q.sum(0)
    g_hat = (total * scale / R).to(stacked_g.dtype)
    return g_hat, c - q * scale


def _emulated_hier_compressed_mean(stacked_g, stacked_e, *, n_nodes: int):
    """One-process twin of the hierarchical reduction: gradients stacked
    ``[R, ...]`` (node-major) are averaged inside each node, then the
    per-node means go through the error-feedback int8 compression across
    nodes, residuals ``[n_nodes, ...]``.  ``n_nodes == 1`` is the
    collective's ``group_size=1`` identity (no quantisation, residual
    untouched).  Returns ``(g_hat_mean, new_stacked_e)``."""
    R = stacked_g.shape[0]
    dpn = R // n_nodes
    node_g = stacked_g.to(torch.float32).reshape((n_nodes, dpn) + stacked_g.shape[1:]).mean(1)
    if n_nodes == 1:
        return node_g[0].to(stacked_g.dtype), stacked_e
    c = node_g + stacked_e
    scale = c.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(c / scale), -127, 127)
    total = q.sum(0)
    g_hat = (total * scale / n_nodes).to(stacked_g.dtype)
    return g_hat, c - q * scale


def _zeros_ef(params, lead: int, compress: bool):
    """Error-feedback residuals ``[lead, ...]`` per parameter (empty when
    the compressed all-reduce is off)."""
    if not compress:
        return ()
    return tree_map(lambda p: torch.zeros((lead,) + tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)


class _Engine:
    """What the engines share: collation of this process's ranks, the
    per-bin gradients, and teardown."""

    name = ""

    def __init__(self, mace_cfg: MaceConfig, tcfg, optimizer: Transform,
                 n_graphs: int, device: torch.device):
        self.mace_cfg = mace_cfg
        self.n_ranks = tcfg.n_ranks
        self.device = device
        self.optimizer = optimizer
        self.compress = tcfg.compress_grads
        # collation emits the blk_* arrays when the interaction impl reads them
        self.with_blocking = interaction_consumes_blocking(mace_cfg)
        self.telemetry = RankTelemetry(self.n_ranks)
        self._loss_fn = make_loss_fn(mace_cfg, tcfg, n_graphs)
        self.closed = False

    @property
    def local_rank_range(self) -> range:
        """Ranks whose molecules this process materialises for
        ``collate``."""
        return range(self.n_ranks)

    def place_replicated(self, tree):
        """Replicated state (parameters, optimizer state, EMA) on this
        engine's device."""
        return tree_map(lambda t: t.to(self.device), tree)

    def close(self) -> None:
        """Teardown; idempotent, and ``step`` raises afterwards."""
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()

    def collate(self, mols_per_rank: Sequence[Sequence[Any]], shape: BinShape):
        """Numpy batches of this process's ranks (host work only); the
        entries of other ranks are never read."""
        if len(mols_per_rank) != self.n_ranks:
            raise ValueError(f"got {len(mols_per_rank)} bins for {self.n_ranks} ranks")
        stats = {"block_s": 0.0}
        cols = [collate_bin(mols_per_rank[r], shape, with_blocking=self.with_blocking,
                            timings=stats)
                for r in self.local_rank_range]
        return cols, stats

    def to_device(self, batches) -> List[Batch]:
        out = []
        for b in batches:
            d = DeviceBatch({k: torch.from_numpy(v).to(self.device) for k, v in b.items()})
            d.real_atoms = float(np.count_nonzero(b["node_mask"]))
            out.append(d)
        return out

    def grads(self, params, batch: Batch) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(flat gradients, metrics) of the loss on one bin; a parameter the
        loss does not reach gets zeros.  Its span is handed to the twins'
        spans, which a CUDA backward opens on autograd's device thread."""
        with tracing.span("train.grads") as sp, tracing.handoff(sp):
            flat = {k: v.detach().requires_grad_(True) for k, v in flatten(params).items()}
            loss, metrics = self._loss_fn(unflatten(flat), batch)
            grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        return ({k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(flat.items(), grads)},
                {k: v.detach() for k, v in metrics.items()})

    def settle(self) -> None:
        """Record what the last step left pending in the telemetry (the
        sequential engine's; the others record within the step)."""

    def _timed_grads(self, params, batch: Batch):
        """``grads`` with its wall seconds, read after the device is done:
        the distributed engines gather the time within the step."""
        t0 = time.perf_counter()
        grads, metrics = self.grads(params, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return grads, metrics, time.perf_counter() - t0

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("engine is closed")


class SequentialEngine(_Engine):
    """Per-bin loop over logical ranks on one device: gradients are
    combined as the all-reduce would combine them, so a run with R logical
    ranks here is the oracle of a run of the distributed engines with R
    processes."""

    name = "sequential"

    def __init__(self, mace_cfg: MaceConfig, tcfg, optimizer: Transform,
                 n_graphs: int, device: torch.device):
        super().__init__(mace_cfg, tcfg, optimizer, n_graphs, device)
        # n_nodes set -> the hierarchical reduction of MultiHostEngine
        self.n_nodes = tcfg.n_nodes
        if self.n_nodes and self.n_ranks % self.n_nodes:
            raise ValueError(
                f"n_ranks={self.n_ranks} not divisible by n_nodes={self.n_nodes}")
        self._pending = None  # the last step's bin timers and loads

    def init_ef(self, params):
        """Fresh residuals ``[R, ...]``, or ``[n_nodes, ...]`` with
        ``n_nodes`` set (one per quantisation site)."""
        return _zeros_ef(params, self.n_nodes or self.n_ranks, self.compress)

    def step(self, params, opt_state, ef_state, batches: List[DeviceBatch], step: int):
        """One step on ``to_device``'s batches; their bin times and real
        atoms reach the telemetry at ``settle()`` (the trainer's, after it
        reads the step's metrics) or, at the latest, at the next step."""
        self._check_open()
        self.settle()
        grads_l, metrics_l, timers = [], [], []
        for b in batches:
            timer = _BinTimer(self.device)
            grads, metrics = self.grads(params, b)
            timer.stop()
            timers.append(timer)
            grads_l.append(grads)
            metrics_l.append(metrics)
        self._pending = (timers, [b.real_atoms for b in batches])
        with tracing.span("train.optimizer"):
            return self.finalize(params, opt_state, ef_state, grads_l, metrics_l, step)

    def settle(self) -> None:
        """Record the last step's bin seconds and real atoms.  Called after
        the step's metrics were read, it waits for nothing: that read waited
        for the bins' work."""
        if self._pending is None:
            return
        timers, loads = self._pending
        self._pending = None
        self.telemetry.record([t.seconds() for t in timers], loads)

    def finalize(self, params, opt_state, ef_state, grads_l, metrics_l, step: int):
        """The ranks' flat gradients and metrics -> one optimizer update:
        the all-reduce's combination (mean, or the emulated compressed
        mean with its residuals) and AdamW.  Returns ``(params, opt_state,
        ef_state, metrics)``."""
        with torch.no_grad():
            stacked = {k: torch.stack([g[k] for g in grads_l]) for k in grads_l[0]}
            if self.compress:
                reduce = (partial(_emulated_hier_compressed_mean, n_nodes=self.n_nodes)
                          if self.n_nodes else _emulated_compressed_mean_ef)
                ef = flatten(ef_state)
                pairs = {k: reduce(g, ef[k]) for k, g in stacked.items()}
                grads = unflatten({k: p[0] for k, p in pairs.items()})
                ef_state = unflatten({k: p[1] for k, p in pairs.items()})
            else:
                grads = unflatten({k: g.mean(0) for k, g in stacked.items()})
            metrics = {k: torch.stack([m[k] for m in metrics_l]).mean(0)
                       for k in metrics_l[0]}
        updates, opt_state = self.optimizer.update(grads, opt_state, params, step)
        return apply_updates(params, updates), opt_state, ef_state, metrics


def flat_mean(flat: Dict[str, torch.Tensor], group, n: int) -> Dict[str, torch.Tensor]:
    """Plain mean of every tensor of ``flat`` over ``group`` (``n``
    ranks), through one flat buffer; the identity for one rank."""
    if n == 1:
        return flat
    buf = torch.cat([t.reshape(-1) for t in flat.values()])
    all_reduce_(buf, dist.ReduceOp.SUM, group)
    buf /= n
    out, at = {}, 0
    for k, t in flat.items():
        out[k] = buf[at:at + t.numel()].view_as(t)
        at += t.numel()
    return out


class DataParallelEngine(_Engine):
    """One process per rank on a flat group: each process takes the
    gradients of its own bin and all-reduces them (see the module
    docstring)."""

    name = "data_parallel"

    def __init__(self, mace_cfg: MaceConfig, tcfg, optimizer: Transform,
                 n_graphs: int, device: torch.device):
        super().__init__(mace_cfg, tcfg, optimizer, n_graphs, device)
        self.group = make_dp_group(self.n_ranks)  # one process per rank
        self.process_index = dist.get_rank()
        self.process_count = dist.get_world_size()
        # gloo runs all_gather on host tensors only
        self._gather_device = (torch.device("cpu") if dist.get_backend() == "gloo"
                               else self.device)
        self._make_groups(tcfg)

    def _make_groups(self, tcfg) -> None:
        """The groups of the reduction besides the flat one (none here)."""

    @property
    def local_rank_range(self) -> range:
        return range(self.process_index, self.process_index + 1)

    def init_ef(self, params):
        """Fresh residuals ``[1, ...]``: this rank's row of the oracle's
        ``[R, ...]``."""
        return _zeros_ef(params, 1, self.compress)

    def barrier(self, name: str) -> None:
        """Cross-process sync point (the checkpoint commit protocol)."""
        dist.barrier()

    def _compressed(self, flat, ef_state, group, group_size=None):
        """``compressed_allreduce_ef`` of every tensor of ``flat``, with
        the ``[1, ...]`` residuals of ``ef_state``."""
        keys = list(flat)
        ef = flatten(ef_state)
        g_hat, new_e = compressed_allreduce_ef(
            [flat[k] for k in keys], [ef[k][0] for k in keys], group,
            group_size=group_size)
        return dict(zip(keys, g_hat)), unflatten({k: e[None] for k, e in zip(keys, new_e)})

    def reduce_grads(self, grads: Dict[str, torch.Tensor], ef_state):
        """The gradients' mean over the ranks, and the new residuals."""
        if self.compress:
            return self._compressed(grads, ef_state, self.group)
        return flat_mean(grads, self.group, self.n_ranks), ef_state

    def _gather(self, values: Sequence[float]) -> np.ndarray:
        """``[R, len(values)]``: every rank's ``values``, in rank order."""
        mine = torch.tensor(values, dtype=torch.float64, device=self._gather_device)
        rows = [torch.empty_like(mine) for _ in range(self.process_count)]
        dist.all_gather(rows, mine)
        return torch.stack(rows).cpu().numpy()

    def step(self, params, opt_state, ef_state, batches: List[Batch], step: int):
        self._check_open()
        (batch,) = batches
        grads, metrics, seconds = self._timed_grads(params, batch)
        with torch.no_grad():
            grads, ef_state = self.reduce_grads(grads, ef_state)
            metrics = flat_mean(metrics, None, self.process_count)
        updates, opt_state = self.optimizer.update(unflatten(grads), opt_state, params, step)
        rows = self._gather([seconds, batch.real_atoms])
        self.telemetry.record(rows[:, 0], rows[:, 1])
        return apply_updates(params, updates), opt_state, ef_state, metrics


class MultiHostEngine(DataParallelEngine):
    """One process per rank in an ``n_nodes`` x ``devices_per_node`` grid:
    the mean over the node's devices, then the plain or int8-compressed
    mean across nodes (see the module docstring)."""

    name = "multihost"

    def _make_groups(self, tcfg) -> None:
        # one process per node when n_nodes is not given, as in the JAX engine
        self.n_nodes = tcfg.n_nodes or self.process_count
        if self.n_ranks % self.n_nodes:
            raise ValueError(
                f"n_ranks={self.n_ranks} not divisible by n_nodes={self.n_nodes}")
        self.devices_per_node = self.n_ranks // self.n_nodes
        self.device_group, self.node_group = make_node_device_groups(
            self.n_nodes, self.devices_per_node)

    def reduce_grads(self, grads: Dict[str, torch.Tensor], ef_state):
        # level 1: the mean inside the node, unquantised
        grads = flat_mean(grads, self.device_group, self.devices_per_node)
        # level 2: across nodes; the residual is per node
        if self.compress:
            return self._compressed(grads, ef_state, self.node_group,
                                    group_size=self.n_nodes)
        return flat_mean(grads, self.node_group, self.n_nodes), ef_state


ENGINES = {
    SequentialEngine.name: SequentialEngine,
    DataParallelEngine.name: DataParallelEngine,
    MultiHostEngine.name: MultiHostEngine,
}


def make_engine(name: str, mace_cfg: MaceConfig, tcfg, optimizer: Transform,
                n_graphs: int, device: torch.device):
    """Engine factory: ``name`` in {"sequential", "data_parallel",
    "multihost"} (the JAX names through ``bridge.JAX_ENGINE_NAMES``).

    ``"auto"`` impl sentinels the caller left in ``mace_cfg`` resolve here
    from the tuning table, a safety net for callers that build engines
    directly.  The tile search is pinned to ``(tcfg.block_n,
    tcfg.block_e)``: the collation contract is fixed at this layer, so the
    decision may pick the impl and its backward but not the geometry (the
    Trainer resolves before it builds its BinShape and adopts the
    decision's geometry instead)."""
    try:
        cls = ENGINES[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; available: {sorted(ENGINES)}") from None
    mace_cfg, _ = autotune.resolve_mace_config(
        mace_cfg, capacity=tcfg.capacity, edge_factor=tcfg.edge_factor,
        platform=autotune.platform_of(device),
        block_candidates=[(tcfg.block_n, tcfg.block_e)],
    )
    return cls(mace_cfg, tcfg, optimizer, n_graphs, device)
