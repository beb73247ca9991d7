"""The sequential execution engine: one step API over R logical ranks.

Port of the sequential half of the JAX package's ``train/engine.py``:

    engine.collate(mols_per_rank, bin_shape)
                     -> (numpy batches, host stats {"block_s": s})
    engine.to_device(batches)                -> the batches on the device
    engine.step(params, opt_state, batches, step)
                                    -> (params, opt_state, metrics)

``collate`` is numpy only, so it may run on the prefetch producer thread;
``to_device`` and ``step`` run on the trainer's thread.  ``step`` takes the
weighted loss and its parameter gradients once per rank's bin (the forces
term makes that a grad-of-grad), averages the gradients over the ranks as
the distributed all-reduce would, and applies one optimizer update.  Each
rank's step time is read after ``torch.cuda.synchronize``, so
:class:`RankTelemetry` holds measured per-rank times for the straggler
model.

Not ported: the shard_map and multi-host engines, the int8
error-feedback compression of the all-reduce, remat, engine teardown and
the telemetry of elastic rescale (the port does not rescale).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.core.mace import MaceConfig, weighted_loss
from repro_torch.data.collate import BinShape, collate_bin
from repro_torch.kernels import registry

from .optimizer import Transform, apply_updates

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class RankTelemetry:
    """Per-step, per-rank measurements accumulated over a run.  Summary
    methods take ``skip``: pass ``skip=1`` to drop the first step (kernel
    builds and first-touch allocations)."""

    n_ranks: int
    times: List[List[float]] = dataclasses.field(default_factory=list)
    loads: List[List[float]] = dataclasses.field(default_factory=list)
    # host-side prefetch telemetry (one scalar per step)
    host_collate: List[float] = dataclasses.field(default_factory=list)
    host_wait: List[float] = dataclasses.field(default_factory=list)
    # seconds of ``collate_s`` spent building the edge blocking
    host_block: List[float] = dataclasses.field(default_factory=list)

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

    @property
    def n_steps(self) -> int:
        return len(self.times)

    def work_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, ranks] wall seconds."""
        return np.asarray(self.times[skip:], dtype=np.float64).reshape(-1, self.n_ranks)

    def load_matrix(self, skip: int = 0) -> np.ndarray:
        """[steps, ranks] real atoms per bin."""
        return np.asarray(self.loads[skip:], dtype=np.float64).reshape(-1, self.n_ranks)

    def c_token(self, skip: int = 0) -> float:
        """Calibrated per-atom step cost (seconds/atom)."""
        t, loads = self.work_matrix(skip), self.load_matrix(skip)
        if t.size == 0:
            return 0.0
        return float(t.sum()) / max(float(loads.sum()), 1.0)

    def measured_straggler(self, skip: int = 0) -> float:
        """Mean over steps of (max rank time / mean rank time)."""
        w = self.work_matrix(skip)
        if w.size == 0:
            return 1.0
        return float(np.mean(w.max(axis=1) / np.maximum(w.mean(axis=1), 1e-12)))

    def overlap_seconds(self, skip: int = 0) -> float:
        """Collate seconds hidden behind device compute: per step
        ``max(collate_s - wait_s, 0)``, summed."""
        c = np.asarray(self.host_collate[skip:], np.float64)
        w = np.asarray(self.host_wait[skip:], np.float64)
        return float(np.maximum(c - w, 0.0).sum())

    def overlap_fraction(self, skip: int = 0) -> float:
        total = float(np.sum(self.host_collate[skip:]))
        return self.overlap_seconds(skip) / total if total > 0 else 0.0

    def blocking_seconds(self, skip: int = 0) -> float:
        return float(np.sum(self.host_block[skip:]))


def make_loss_fn(mace_cfg: MaceConfig, tcfg, n_graphs: int) -> Callable:
    def loss_fn(params, batch):
        return weighted_loss(
            params, mace_cfg, batch, n_graphs,
            tcfg.energy_weight, tcfg.forces_weight,
        )

    return loss_fn


def interaction_consumes_blocking(mace_cfg: MaceConfig) -> bool:
    """True when the model's interaction impl reads pre-blocked edges: the
    engines then ask collation for the ``blk_*`` arrays.  A name registered
    only as a TP-only kernel (``core.interaction.resolve_interaction``'s
    fallback) reads none."""
    try:
        impl = registry.get_impl("interaction", mace_cfg.interaction_impl_name)
    except KeyError:
        return False
    return impl.consumes_blocking


class SequentialEngine:
    """Per-bin loop over logical ranks on one device: gradients are
    averaged over the ranks as the all-reduce would average them."""

    def __init__(self, mace_cfg: MaceConfig, tcfg, optimizer: Transform,
                 n_graphs: int, device: torch.device):
        self.n_ranks = tcfg.n_ranks
        self.device = device
        self.optimizer = optimizer
        # collation emits the blk_* arrays when the interaction impl reads them
        self.with_blocking = interaction_consumes_blocking(mace_cfg)
        self.telemetry = RankTelemetry(self.n_ranks)
        self._loss_fn = make_loss_fn(mace_cfg, tcfg, n_graphs)

    def collate(self, mols_per_rank: Sequence[Sequence[Any]], shape: BinShape):
        """Numpy batches, one per rank (host work only)."""
        stats = {"block_s": 0.0}
        cols = [collate_bin(m, shape, with_blocking=self.with_blocking, timings=stats)
                for m in mols_per_rank]
        return cols, stats

    def to_device(self, batches) -> List[Batch]:
        return [{k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
                for b in batches]

    def grads(self, params, batch: Batch) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(flat gradients, metrics) of the loss on one bin; a parameter the
        loss does not reach gets zeros."""
        flat = {k: v.detach().requires_grad_(True) for k, v in flatten(params).items()}
        loss, metrics = self._loss_fn(unflatten(flat), batch)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        return ({k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(flat.items(), grads)},
                {k: v.detach() for k, v in metrics.items()})

    def step(self, params, opt_state, batches: List[Batch], step: int):
        grads_l, metrics_l, times, loads = [], [], [], []
        for b in batches:
            t0 = time.perf_counter()
            grads, metrics = self.grads(params, b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
            loads.append(float(b["node_mask"].sum()))
            grads_l.append(grads)
            metrics_l.append(metrics)
        with torch.no_grad():
            grads = unflatten({k: torch.stack([g[k] for g in grads_l]).mean(0)
                               for k in grads_l[0]})
            metrics = {k: torch.stack([m[k] for m in metrics_l]).mean(0)
                       for k in metrics_l[0]}
        updates, opt_state = self.optimizer.update(grads, opt_state, params, step)
        self.telemetry.record(times, loads)
        return apply_updates(params, updates), opt_state, metrics
