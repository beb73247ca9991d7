"""Trainer: the epoch loop over an execution engine, with checkpoints.

Port of the JAX package's ``train/train_loop.py`` at a fixed rank count:
the balanced sampler (Algorithm 1 per epoch; the two-level
``HierarchicalBalancedSampler`` when ``n_nodes`` is set) or the fixed-count
baseline, numpy collation driven through ``data.prefetch.PrefetchPipeline``
(``TrainerConfig.prefetch`` sets the lookahead; 0 runs the same path
inline), an engine from ``train.engine.make_engine`` (``sequential``, the
one-process oracle over R logical ranks, or ``data_parallel`` /
``multihost``, one process per rank on ``torch.distributed``: weighted
loss with forces, the gradients' mean over the ranks, plain or int8 with
error feedback, clip + AdamW), EMA, periodic atomic checkpoints (one shard
per process, committed together) and resume (parameters, optimizer state,
EMA, error-feedback residuals and the sampler cursor).
``simulate_failure_at`` lets a test kill the loop mid-epoch to prove that a
restart equals an uninterrupted run.

The trainer runs on the CUDA card unless it is given ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.  The initial
parameters may be passed in (a test hands it the JAX package's, bridged);
otherwise they are drawn from ``seed`` with a CPU ``torch.Generator``, the
same in every rank process, which cannot reproduce the JAX package's
``jax.random`` draws.  A distributed engine needs the process group up
(``launch.multihost.initialize_distributed``) before the trainer is built;
the process index and count come from the engine.

Not ported: elastic rescale (``rescale``, ``ElasticTrainer``, restore
across rank or process counts), remat, the heartbeat, the step watchdog
and the fault plan.

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
import time
from typing import Any, Dict, Optional

import torch

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

from .checkpoint import latest_step, read_meta, restore_checkpoint, save_checkpoint
from .engine import make_engine
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
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10              # the training entry point's loss lines


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

    @property
    def telemetry(self):
        return self.engine.telemetry

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
                  "n_ranks": self.engine.n_ranks, "lineage": []},
            process_index=self._process_index,
            process_count=self._process_count,
            barrier=getattr(self.engine, "barrier", None),
        )

    def maybe_restore(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d or latest_step(d) is None:
            return False
        _, meta = read_meta(d)
        ckpt_ranks = int(meta.get("n_ranks", self.engine.n_ranks))
        ckpt_procs = int(meta.get("process_count", 1))
        if ckpt_ranks != self.engine.n_ranks or meta.get("lineage"):
            raise ValueError(
                f"checkpoint in {d} was written at n_ranks={ckpt_ranks} (or "
                f"mid-rescale) but this trainer runs n_ranks={self.engine.n_ranks}; "
                "restoring across rank counts is an elastic rescale, which the "
                "port does not do"
            )
        if ckpt_procs != self._process_count:
            raise ValueError(
                f"checkpoint in {d} was written by {ckpt_procs} process(es) "
                f"but this trainer runs {self._process_count}; restoring "
                "across host counts is an elastic rescale, which the port "
                "does not do"
            )
        # restore may fall back to an older committed step (checksum
        # mismatch): track the step and meta it returns
        step, state, meta = restore_checkpoint(
            d, self._state(), process_index=self._process_index,
            expect_process_count=self._process_count)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.ema_params = state["ema"]
        self.ef_state = state["ef"]
        self.global_step = step
        self.sampler_state = SamplerState.from_dict(meta["sampler"])
        return True

    # ------------------------------ loop ----------------------------------

    def _fetch_batch(self, rank_bins):
        """Host side of one step, on the prefetch producer thread:
        materialise the molecules of this process's ranks
        (``engine.local_rank_range``; the others get an empty placeholder)
        and collate them to numpy."""
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
        device executing step t when ``tcfg.prefetch >= 1``.  Returns True
        when ``max_steps`` was reached (the run should stop)."""
        items = self.sampler.step_iter(self.sampler_state)
        if max_steps is not None:
            # bound the producer's lookahead too: no collating (and then
            # discarding) batches past the stop point
            remaining = max_steps - self.global_step
            if remaining <= 0:
                return True
            items = itertools.islice(items, remaining)
        stop = False
        with PrefetchPipeline(items, self._fetch_batch,
                              depth=self.tcfg.prefetch) as pipeline:
            for item in pipeline:
                host_batches, host_stats = item.batch
                batches = self.engine.to_device(host_batches)
                self.params, self.opt_state, self.ef_state, metrics = self.engine.step(
                    self.params, self.opt_state, self.ef_state, batches,
                    self.global_step)
                self.ema_params = self.ema.update(
                    self.ema_params, self.params, self.global_step)
                self.global_step += 1
                self.sampler_state.cursor += 1
                self.engine.telemetry.record_host(
                    item.collate_s, item.wait_s, host_stats.get("block_s", 0.0))
                history.append({k: float(v) for k, v in metrics.items()})
                if simulate_failure_at is not None and self.global_step >= simulate_failure_at:
                    raise RuntimeError("simulated node failure")
                if self.tcfg.ckpt_every and self.global_step % self.tcfg.ckpt_every == 0:
                    self.save()
                if max_steps and self.global_step >= max_steps:
                    stop = True
                    break
        # an early exit drains in-flight batches but never a producer error
        pipeline.raise_pending()
        return stop

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
        self.save()
        return {"history": history, "wall": time.perf_counter() - t_start}
