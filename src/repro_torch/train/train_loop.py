"""Trainer: the fault-tolerant epoch loop over an execution engine.

Port of the JAX package's ``train/train_loop.py``: the balanced sampler
(Algorithm 1 per epoch; the two-level ``HierarchicalBalancedSampler`` when
``n_nodes`` is set) or the fixed-count baseline, numpy collation driven
through ``data.prefetch.PrefetchPipeline`` (``TrainerConfig.prefetch`` sets
the lookahead; 0 runs the same path inline), an engine from
``train.engine.make_engine`` (``sequential``, the one-process oracle over R
logical ranks, or ``data_parallel`` /
``multihost``, one process per rank on ``torch.distributed``: weighted
loss with forces, the gradients' mean over the ranks, plain or int8 with
error feedback, clip + AdamW), EMA, periodic atomic checkpoints (one shard
per process, committed together) and resume (parameters, optimizer state,
EMA, error-feedback residuals and the sampler cursor).
``simulate_failure_at`` lets a test
kill the loop mid-epoch to prove that a restart equals an uninterrupted
run.

The trainer runs on the CUDA card unless it is given ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.  The initial
parameters may be passed in (a test hands it the JAX package's, bridged);
otherwise they are drawn from ``seed`` with a CPU ``torch.Generator``, the
same in every rank process, which cannot reproduce the JAX package's
``jax.random`` draws.  A distributed engine needs the process group up
(``launch.multihost.initialize_distributed``) before the trainer is built;
the process index and count come from the engine.

Elastic mid-run rescale
-----------------------
MACE's data parallelism is graph-level (one Algorithm-1 bin per rank, never
a partitioned graph), so changing the rank count mid-run is a host-side
re-pack plus an engine rebuild: no model state is sharded by rank except
the compressed all-reduce's error-feedback residuals.
``Trainer.rescale(n_ranks)`` is that operation at a step boundary:

1. snapshot ``(params, opt_state, ema, ef, SamplerState)`` through the
   atomic checkpoint (a crash mid-rescale restores the pre-rescale run);
2. remap the sampler via ``sampler.rescale``: the consumed bin prefix at
   the old rank count is excluded and the epoch *remainder* re-packed at
   the new one, so no graph is dropped or duplicated (``data.sampler``);
3. ``engine.close()`` then ``make_engine`` at the new rank count on the
   trainer's device: the same parameters, optimizer state and EMA, the
   error-feedback residuals re-initialised at the new leading dim;
4. the epoch loop re-enters a fresh prefetch pipeline (in-flight batches
   collated at the old rank count were drained and discarded).

``ElasticTrainer`` drives this from a ``{global_step: new_R}`` schedule
(the ``--rescale-at STEP:R`` drill).  Checkpoints are portable across rank
and process counts: meta records ``n_ranks`` and the epoch's rescale
lineage, so ``maybe_restore`` with ``TrainerConfig.elastic`` replays the
(deterministic) remap chain and continues a checkpoint written at R = 4 on
an R = 1 or R = 2 trainer, or by 2 processes on 1, with parameters,
optimizer state and EMA restored exactly and the residuals re-initialised.

One difference from the JAX package: its ``ShardMapEngine`` rescales
inside one process over that process's devices, while the port's
``data_parallel`` and ``multihost`` engines run one process per rank.  So
an in-process ``rescale`` works on the ``sequential`` engine, and on a
multi-process engine a rank count other than the world's raises: the route
there is a restart at the new world size with ``elastic=True``, which
``launch.train --supervised`` does.

Resilience: the ``REPRO_FAULT_PLAN`` sites ``crash_at_step`` (after a step,
before its checkpoint), ``hang_at_step`` and ``slow_collate`` (in
collation) fire here; with a heartbeat directory (``heartbeat_dir`` or the
``REPRO_HEARTBEAT_DIR`` a ``PodSupervisor`` hands its children) every step
publishes a heartbeat, and ``step_deadline_s`` arms a ``StepWatchdog``
around the pipeline wait and the step (exit 44 when it expires).

``TrainerConfig.impl``, ``interaction_impl``, ``interaction_bwd_impl`` and
``precision``, when set, override the model config's fields of those names
(as the JAX package's ``TrainerConfig`` does).  An ``"auto"`` impl is then
resolved from the tuning table for this run's shape bucket and the
trainer's platform (``kernels.autotune.resolve_mace_config``) before the
``BinShape`` is built, so that the interaction decision's tile geometry
becomes the collation's; the decisions are kept in
``Trainer.autotune_decisions``.  ``Trainer.mace_cfg`` is the config the
run uses.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.bridge import resolve_device
from repro_torch.core.mace import MaceConfig, init_mace
from repro_torch.data.collate import BinShape
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.data.prefetch import PrefetchPipeline
from repro_torch.data.sampler import (
    BalancedBatchSampler,
    FixedCountSampler,
    HierarchicalBalancedSampler,
    SamplerState,
)
from repro_torch.kernels import autotune
from repro_torch.resilience.faults import FaultPlan
from repro_torch.resilience.heartbeat import ENV_HEARTBEAT_DIR, HeartbeatWriter, StepWatchdog

from .checkpoint import latest_step, read_meta, restore_checkpoint, save_checkpoint
from .engine import RankTelemetry, make_engine
from .optimizer import EMA, adamw, chain, clip_by_global_norm


@dataclasses.dataclass
class TrainerConfig:
    capacity: int = 512
    edge_factor: int = 48
    max_graphs: int = 64
    n_ranks: int = 1                 # logical DP ranks (bins per step)
    lr: float = 5e-3
    weight_decay: float = 0.0
    clip_norm: float = 10.0
    ema_decay: float = 0.99
    energy_weight: float = 1.0
    forces_weight: float = 100.0
    compress_grads: bool = False     # int8 + error-feedback gradient all-reduce
    engine: str = "sequential"       # "sequential" | "data_parallel" | "multihost"
    # pod topology: n_nodes x (n_ranks // n_nodes) ranks, node-major.  Set ->
    # two-level Algorithm-1 packing and the hierarchical reduction (the
    # intra-node mean, int8 error feedback across nodes only).  None keeps
    # the flat layout.
    n_nodes: Optional[int] = None
    prefetch: int = 0                # async collate lookahead depth (0 = inline)
    # edge blocking tile shape (data.blocking); block_n must match
    # MaceConfig.interaction_block_n
    block_n: int = 32
    block_e: int = 128
    fixed_graphs_per_batch: int = 8   # baseline sampler's PyG-style count
    # overrides of MaceConfig's kernel selection, when set: impl (the
    # symmetric contraction), interaction_impl (either may be "auto"),
    # interaction_bwd_impl ("cuda" | "fused") and precision ("fp32" |
    # "bf16" | "fp8")
    impl: Optional[str] = None
    interaction_impl: Optional[str] = None
    interaction_bwd_impl: Optional[str] = None
    precision: Optional[str] = None
    # restore a checkpoint written at another rank or process count (the
    # residuals re-initialised, the sampler lineage replayed);
    # ElasticTrainer and the supervised relaunches force it on
    elastic: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10              # the training entry point's loss lines
    # resilience: directory of the per-step heartbeat files (else the
    # REPRO_HEARTBEAT_DIR a PodSupervisor sets for its children), and a
    # per-step wall-clock deadline: a step past it trips the StepWatchdog
    # (exit 44), which a supervisor sees as a hang
    heartbeat_dir: Optional[str] = None
    step_deadline_s: Optional[float] = None


class Trainer:
    def __init__(
        self,
        mace_cfg: MaceConfig,
        tcfg: TrainerConfig,
        dataset: SyntheticCFMDataset,
        *,
        sampler: str = "balanced",
        seed: int = 0,
        params: Optional[Dict[str, Any]] = None,
        device: Optional[Any] = None,
    ):
        self.device = resolve_device(device)
        overrides = {f: getattr(tcfg, f) for f in (
            "impl", "interaction_impl", "interaction_bwd_impl", "precision")}
        mace_cfg = dataclasses.replace(
            mace_cfg, **{f: v for f, v in overrides.items() if v is not None})
        # "auto" resolves for THIS run's shape bucket before the BinShape is
        # built, so that the interaction decision's tile geometry flows into
        # the collation (the block_n check below holds by construction)
        mace_cfg, self.autotune_decisions = autotune.resolve_mace_config(
            mace_cfg, capacity=tcfg.capacity, edge_factor=tcfg.edge_factor,
            platform=autotune.platform_of(self.device))
        d = self.autotune_decisions.get("interaction")
        if d is not None and d.block_n is not None:
            tcfg = dataclasses.replace(tcfg, block_n=int(d.block_n), block_e=int(d.block_e))
        self.mace_cfg = mace_cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.bin_shape = BinShape.for_capacity(
            tcfg.capacity, tcfg.edge_factor, tcfg.max_graphs,
            block_n=tcfg.block_n, block_e=tcfg.block_e,
        )
        if sampler == "balanced" and tcfg.n_nodes:
            if tcfg.n_ranks % tcfg.n_nodes:
                raise ValueError(
                    f"n_ranks={tcfg.n_ranks} not divisible by n_nodes={tcfg.n_nodes}")
            self.sampler = HierarchicalBalancedSampler(
                dataset.sizes, tcfg.capacity, tcfg.n_nodes,
                tcfg.n_ranks // tcfg.n_nodes, seed=seed)
        elif sampler == "balanced":
            self.sampler = BalancedBatchSampler(
                dataset.sizes, tcfg.capacity, tcfg.n_ranks, seed=seed)
        elif sampler == "fixed":
            self.sampler = FixedCountSampler(
                dataset.sizes, graphs_per_batch=tcfg.fixed_graphs_per_batch,
                n_ranks=tcfg.n_ranks, seed=seed,
            )
        else:
            raise ValueError(f"unknown sampler {sampler!r}; use 'balanced' or 'fixed'")

        self.optimizer = chain(
            clip_by_global_norm(tcfg.clip_norm),
            adamw(tcfg.lr, weight_decay=tcfg.weight_decay),
        )
        self.ema = EMA(tcfg.ema_decay)
        self.engine = make_engine(tcfg.engine, mace_cfg, tcfg, self.optimizer,
                                  tcfg.max_graphs, self.device)
        if params is None:
            params = init_mace(mace_cfg, torch.Generator().manual_seed(seed))
        self.params = self.engine.place_replicated(params)
        self.opt_state = self.optimizer.init(self.params)
        self.ema_params = self.ema.init(self.params)
        # the compressed all-reduce's residuals (empty when it is off)
        self.ef_state = self.engine.init_ef(self.params)
        self.global_step = 0
        self.sampler_state = SamplerState(epoch=0, cursor=0)
        # one static tile geometry shared by the data pipeline and the kernel
        if self.engine.with_blocking and (
            self.bin_shape.block_n != mace_cfg.interaction_block_n
        ):
            raise ValueError(
                f"BinShape.block_n={self.bin_shape.block_n} != "
                f"MaceConfig.interaction_block_n={mace_cfg.interaction_block_n}"
            )
        # elastic rescale: {global_step: new_R} fired at step boundaries,
        # this epoch's rescale lineage (how the current packing derives from
        # the full one, checkpointed for a restore at another R), and the
        # per-event records
        self.rescale_schedule: Dict[int, int] = {}
        self._lineage: List[Dict[str, int]] = []
        self.rescale_events: List[Dict[str, Any]] = []
        # telemetry of the engines past rescales closed (oldest first)
        self.telemetry_generations: List[RankTelemetry] = []
        # resilience: the env-armed fault plan (empty without
        # REPRO_FAULT_PLAN), the heartbeat a PodSupervisor polls, and the
        # in-process step watchdog
        self.fault_plan = FaultPlan.from_env()
        hb_dir = tcfg.heartbeat_dir or os.environ.get(ENV_HEARTBEAT_DIR)
        self.heartbeat = (HeartbeatWriter(hb_dir, self._process_index, plan=self.fault_plan)
                          if hb_dir else None)
        self.watchdog = StepWatchdog(tcfg.step_deadline_s) if tcfg.step_deadline_s else None

    @property
    def telemetry(self):
        """Whole-run telemetry: the live engine's ``RankTelemetry`` when no
        rescale has happened, else a ``RankTelemetry.merged`` view over
        every engine generation (the closed ones and the live one)."""
        if not self.telemetry_generations:
            return self.engine.telemetry
        return RankTelemetry.merged(*self.telemetry_generations, self.engine.telemetry)

    @property
    def _process_index(self) -> int:
        return getattr(self.engine, "process_index", 0)

    @property
    def _process_count(self) -> int:
        return getattr(self.engine, "process_count", 1)

    # -------------------------- checkpoints --------------------------------

    def _state(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "ema": self.ema_params, "ef": self.ef_state}

    def save(self):
        if not self.tcfg.ckpt_dir:
            return
        save_checkpoint(
            self.tcfg.ckpt_dir, self.global_step, self._state(),
            meta={"sampler": self.sampler_state.to_dict(),
                  "n_ranks": self.engine.n_ranks,
                  "lineage": [dict(h) for h in self._lineage]},
            process_index=self._process_index,
            process_count=self._process_count,
            barrier=getattr(self.engine, "barrier", None),
        )

    def maybe_restore(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d or latest_step(d) is None:
            return False
        step, meta = read_meta(d)
        eng_procs = self._process_count
        ckpt_ranks = int(meta.get("n_ranks", self.engine.n_ranks))
        ckpt_procs = int(meta.get("process_count", 1))
        cross_rank = ckpt_ranks != self.engine.n_ranks
        cross_proc = ckpt_procs != eng_procs
        if cross_rank and not self.tcfg.elastic:
            raise ValueError(
                f"checkpoint in {d} was written at n_ranks={ckpt_ranks} but "
                f"this trainer runs n_ranks={self.engine.n_ranks}; set "
                "TrainerConfig.elastic=True to restore across rank counts"
            )
        if cross_proc and not self.tcfg.elastic:
            raise ValueError(
                f"checkpoint in {d} was written by {ckpt_procs} process(es) "
                f"but this trainer runs {eng_procs}; set "
                "TrainerConfig.elastic=True to restore across host counts "
                "(losing a host is a rescale event)"
            )
        template = self._state()
        if cross_rank or cross_proc:
            # the residuals' leading dim and process layout are bound to the
            # topology: leave them out and re-initialise them below
            template = {k: v for k, v in template.items() if k != "ef"}
        read_proc = self._process_index
        if cross_proc or read_proc >= ckpt_procs:
            # replicated state is the same in every writer's shard, and
            # shard 0 exists whatever either topology
            read_proc = 0
        # restore may fall back to an older committed step (checksum
        # mismatch): everything below tracks the step and meta it returns
        step, state, meta = restore_checkpoint(
            d, template, step=step, process_index=read_proc,
            expect_process_count=None if self.tcfg.elastic else eng_procs)
        ckpt_ranks = int(meta.get("n_ranks", ckpt_ranks))
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.ema_params = state["ema"]
        self.ef_state = (self.engine.init_ef(self.params) if cross_rank or cross_proc
                         else state["ef"])
        self.global_step = step
        st = SamplerState.from_dict(meta["sampler"])
        lineage = [dict(h) for h in meta.get("lineage", [])]
        if lineage or cross_rank:
            self.sampler, self.sampler_state, self._lineage = self._replay_lineage(
                st, lineage, ckpt_ranks)
        else:
            self.sampler_state = st
            self._lineage = []
        return True

    def _replay_lineage(self, st: SamplerState, lineage, ckpt_ranks: int):
        """Rebuild the checkpoint's epoch packing at *this* trainer's rank
        count: start from the full packing at the first hop's rank count,
        replay each recorded mid-epoch rescale (all deterministic: the same
        sizes, capacity and seed), and append one more remap when the
        checkpoint's rank count differs from ours."""
        hops = lineage + [{"n_ranks": ckpt_ranks, "cursor": st.cursor}]
        sampler = self.sampler.with_ranks(int(hops[0]["n_ranks"]))
        for prev, nxt in zip(hops, hops[1:]):
            sampler, _ = sampler.rescale(
                int(nxt["n_ranks"]), SamplerState(st.epoch, int(prev["cursor"])))
        state = SamplerState(st.epoch, int(hops[-1]["cursor"]))
        if self.engine.n_ranks != ckpt_ranks:
            sampler, state = sampler.rescale(self.engine.n_ranks, state)
            return sampler, state, hops
        return sampler, state, lineage

    # --------------------------- elastic rescale ---------------------------

    def rescale(self, n_ranks: int) -> Dict[str, Any]:
        """Elastic rescale at a step boundary (see the module docstring):
        snapshot -> sampler cursor remap -> engine teardown and rebuild at
        ``n_ranks`` on this trainer's device -> residuals re-initialised.
        Not to be called while an epoch's prefetch pipeline is live: the
        ``rescale_schedule`` (``ElasticTrainer``) drains it first.  Returns
        the event record; its seconds land in the new engine's telemetry.

        A multi-process engine runs one process per rank, so there the
        rank count cannot change inside the run: a count other than the
        world's raises."""
        if self.engine.name != "sequential" and n_ranks != self._process_count:
            raise ValueError(
                f"cannot rescale the {self.engine.name!r} engine from "
                f"{self.engine.n_ranks} to {n_ranks} ranks in process: it runs "
                f"one process per rank and its group has {self._process_count}; "
                f"restart at world size {n_ranks} with TrainerConfig.elastic=True "
                "(the restore re-packs the epoch remainder), which "
                "`python -m repro_torch.launch.train --supervised` does"
            )
        self.save()  # a crash during the rebuild restores the pre-rescale run
        old_ranks = self.engine.n_ranks
        cursor = self.sampler_state.cursor
        t0 = time.perf_counter()
        self.sampler, self.sampler_state = self.sampler.rescale(n_ranks, self.sampler_state)
        repack_s = time.perf_counter() - t0
        self._lineage.append({"n_ranks": old_ranks, "cursor": cursor})
        t1 = time.perf_counter()
        self.telemetry_generations.append(self.engine.telemetry)
        self.engine.close()
        new_nodes = self.tcfg.n_nodes
        if new_nodes:
            # the topology follows the sampler's with_ranks: keep the node
            # width when the new R divides into whole nodes, else go flat
            rpn = old_ranks // new_nodes
            new_nodes = n_ranks // rpn if rpn and n_ranks % rpn == 0 else None
            if new_nodes is None:
                warnings.warn(
                    f"rescale to {n_ranks} ranks: not whole nodes of {rpn}, so the "
                    "packing and the gradient reduction go flat (n_nodes=None)",
                    RuntimeWarning)
        self.tcfg = dataclasses.replace(self.tcfg, n_ranks=n_ranks, n_nodes=new_nodes)
        self.engine = make_engine(self.tcfg.engine, self.mace_cfg, self.tcfg,
                                  self.optimizer, self.tcfg.max_graphs, self.device)
        self.ef_state = self.engine.init_ef(self.params)
        rebuild_s = time.perf_counter() - t1
        self.engine.telemetry.record_rescale(repack_s, rebuild_s)
        event = {"step": self.global_step, "from_ranks": old_ranks, "to_ranks": n_ranks,
                 "n_nodes": new_nodes, "repack_s": repack_s, "rebuild_s": rebuild_s,
                 "discarded_batches": 0}
        self.rescale_events.append(event)
        return event

    # ------------------------------ loop ----------------------------------

    def _fetch_batch(self, rank_bins):
        """Host side of one step, on the prefetch producer thread:
        materialise the molecules of this process's ranks
        (``engine.local_rank_range``; the others get an empty placeholder)
        and collate them to numpy.  The ``slow_collate`` (every call) and
        ``hang_at_step`` (keyed to the live global step: exact inline, about
        one step of slack under prefetch) fault sites fire here."""
        proc = self._process_index
        self.fault_plan.slow_collate(process=proc)
        self.fault_plan.hang_at_step(self.global_step, process=proc)
        local = self.engine.local_rank_range
        mols_per_rank = [[self.dataset.get(i) for i in b] if r in local else []
                         for r, b in enumerate(rank_bins)]
        return self.engine.collate(mols_per_rank, self.bin_shape)

    def run_epoch(
        self,
        history,
        *,
        max_steps: Optional[int] = None,
        simulate_failure_at: Optional[int] = None,
    ) -> bool:
        """Run the rest of the current epoch (from the sampler cursor)
        through the prefetch pipeline: collation of step t+1 overlaps the
        device executing step t when ``tcfg.prefetch >= 1``.  A scheduled
        rescale (``rescale_schedule``) fires at its step boundary: the
        pipeline is drained (in-flight batches at the old rank count
        discarded), ``rescale`` runs, and a fresh pipeline resumes the rest
        of the epoch at the new rank count.  Entries are popped once fired;
        an entry at the *current* step fires before any stepping, so a
        restart from the snapshot ``rescale`` writes at the boundary
        re-applies the rescale it was about to do.  Returns True when
        ``max_steps`` was reached (the run should stop)."""
        pipeline = None
        stop = False
        while True:
            if self.global_step in self.rescale_schedule:
                # the loop just drained the pipeline for this entry, or a
                # restart resumed exactly at the boundary snapshot
                event = self.rescale(self.rescale_schedule.pop(self.global_step))
                if pipeline is not None:
                    event["discarded_batches"] = pipeline.discarded
            # the schedule outranks max_steps: a rescale scheduled at the
            # stop step fires above before this bound stops the loop
            items = self.sampler.step_iter(self.sampler_state)
            if max_steps is not None:
                # bound the producer's lookahead too: no collating (and then
                # discarding) batches past the stop point
                remaining = max_steps - self.global_step
                if remaining <= 0:
                    return True
                items = itertools.islice(items, remaining)
            with PrefetchPipeline(items, self._fetch_batch,
                                  depth=self.tcfg.prefetch) as pipeline:
                # the deadline spans the whole step: the wait on the
                # (possibly hung) producer and the engine step; armed before
                # the wait, re-armed after each step, disarmed on every exit
                if self.watchdog is not None:
                    self.watchdog.arm(self.global_step)
                try:
                    for item in pipeline:
                        t_got = time.perf_counter()
                        with tracing.span("train.step", id=self.global_step,
                                          t0=t_got - item.wait_s) as sp:
                            tracing.add("train.wait", t_got - item.wait_s, t_got)
                            self._step(item, history, sp)
                        if self.heartbeat is not None:
                            self.heartbeat.beat(self.global_step, self.sampler_state.epoch)
                        if self.watchdog is not None:
                            self.watchdog.check()
                            self.watchdog.arm(self.global_step)
                        if (simulate_failure_at is not None
                                and self.global_step >= simulate_failure_at):
                            raise RuntimeError("simulated node failure")
                        self.fault_plan.crash_at_step(self.global_step,
                                                      process=self._process_index)
                        if self.tcfg.ckpt_every and self.global_step % self.tcfg.ckpt_every == 0:
                            self.save()
                        if self.global_step in self.rescale_schedule:
                            break  # leave the with-block: drain, fire at the loop top
                        if max_steps and self.global_step >= max_steps:
                            stop = True
                            break
                finally:
                    if self.watchdog is not None:
                        self.watchdog.disarm()
            # the drain (rescale boundary or max_steps) discards in-flight
            # batches but never an in-flight producer error
            pipeline.raise_pending()
            if stop:
                return True
            if self.global_step not in self.rescale_schedule:
                return False  # the epoch's stream is exhausted, nothing pending

    def _step(self, item, history, sp) -> None:
        """One step of ``run_epoch`` on a prefetched batch, from the copy to
        the device to the read of its metrics; ``sp`` is its ``train.step``
        span, or None when it does not record."""
        host_batches, host_stats = item.batch
        if sp is not None:
            for b in host_batches:
                mask = b["node_mask"]
                sp.count("atoms", int(np.count_nonzero(mask)))
                sp.count("edges", int(np.count_nonzero(b["edge_mask"])))
                sp.count("graphs", int(b["graph_id"][mask].max()) + 1 if mask.any() else 0)
        with tracing.span("train.h2d"):
            batches = self.engine.to_device(host_batches)
        self.params, self.opt_state, self.ef_state, metrics = self.engine.step(
            self.params, self.opt_state, self.ef_state, batches, self.global_step)
        with tracing.span("train.ema"):
            self.ema_params = self.ema.update(self.ema_params, self.params, self.global_step)
        self.global_step += 1
        self.sampler_state.cursor += 1
        self.engine.telemetry.record_host(
            item.collate_s, item.wait_s, host_stats.get("block_s", 0.0))
        with tracing.span("train.sync"):
            history.append({k: float(v) for k, v in metrics.items()})
        self.engine.settle()

    def train(
        self,
        n_epochs: int = 1,
        *,
        max_steps: Optional[int] = None,
        simulate_failure_at: Optional[int] = None,
    ) -> Dict[str, Any]:
        history = []
        t_start = time.perf_counter()
        while self.sampler_state.epoch < n_epochs:
            if self.run_epoch(history, max_steps=max_steps,
                              simulate_failure_at=simulate_failure_at):
                break
            self.sampler_state = SamplerState(self.sampler_state.epoch + 1, 0)
            self._lineage = []  # remainder universes are epoch-scoped
        self.save()
        return {"history": history, "wall": time.perf_counter() - t_start}


def parse_rescale_schedule(specs) -> Dict[int, int]:
    """Parse ``--rescale-at STEP:R`` specs (a repeatable flag and/or
    comma-separated) into a ``{global_step: new_n_ranks}`` schedule."""
    schedule: Dict[int, int] = {}
    if isinstance(specs, str):
        specs = [specs]
    for spec in specs or []:
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            try:
                step_s, ranks_s = part.split(":")
                step, ranks = int(step_s), int(ranks_s)
            except ValueError:
                raise ValueError(f"bad rescale spec {part!r}; want STEP:R") from None
            if step <= 0 or ranks <= 0:
                raise ValueError(
                    f"bad rescale spec {part!r}: STEP and R must be positive")
            schedule[step] = ranks
    return schedule


class ElasticTrainer(Trainer):
    """Trainer wired for mid-run elasticity.

    ``rescale_schedule`` maps global step -> new rank count: when a step in
    the schedule completes, the epoch's prefetch pipeline drains (in-flight
    batches at the old R discarded), the state snapshots through the atomic
    checkpoint, the epoch remainder re-packs for the new rank count (the
    exact cursor remap of ``data.sampler``), and a fresh engine is built
    before the loop resumes.  ``TrainerConfig.elastic`` is forced on, so
    the checkpoints it writes restore across rank counts.
    """

    def __init__(
        self,
        mace_cfg: MaceConfig,
        tcfg: TrainerConfig,
        dataset: SyntheticCFMDataset,
        *,
        rescale_schedule: Optional[Dict[int, int]] = None,
        **kwargs,
    ):
        if not tcfg.elastic:
            tcfg = dataclasses.replace(tcfg, elastic=True)
        super().__init__(mace_cfg, tcfg, dataset, **kwargs)
        self.rescale_schedule = dict(rescale_schedule or {})
