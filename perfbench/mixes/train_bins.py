"""Training on Algorithm-1 bins: one rank of the paper's job, as the port's
``Trainer.train`` runs it on the sequential engine.

Set-up draws the graphs (``datagen``, at the configuration's cutoff) and
the weights from the seed, builds one ``Trainer`` and drives it through its
first ``checked_steps`` steps by the same ``Trainer.train`` call and feed as
the window: those steps are the warm-up, and they are what the reference
follows.  The window then runs the same trainer on for ``--seconds``: a
step hook (the trainer's heartbeat) reads the clock after each step, past
the deadline it synchronises and closes the window, and with ``--trace 1``
it first profiles the steps of the same loop that begin in the next
``profile_s`` seconds.

``train_atoms_per_s`` is the real atoms of the window's steps over the
window, which ends at the synchronize after the last step begun in it.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from perfbench import harness
from perfbench.counts import kernels as kcounts
from perfbench.counts import model as mcounts
from perfbench.datagen import GraphSet
from perfbench.reference import check, mace, optim

MACE_FIELDS = ("n_species", "channels", "hidden_ls", "sh_lmax", "a_ls", "correlation",
               "n_interactions", "r_max", "num_bessel", "radial_mlp", "readout_mlp",
               "avg_num_neighbors", "impl", "interaction_impl", "interaction_bwd_impl",
               "interaction_block_n", "precision")
TRAIN_FIELDS = ("lr", "weight_decay", "clip_norm", "ema_decay", "energy_weight",
                "forces_weight")


class WindowClosed(Exception):
    """Raised by the step hook once the window (and its profiled stretch)
    is over: it ends ``Trainer.train`` between two steps."""


def mace_config(config: Dict[str, Any]):
    from repro_torch.core.mace import MaceConfig

    return MaceConfig(**{f: tuple(config[f]) if isinstance(config[f], list) else config[f]
                         for f in MACE_FIELDS if f in config})


def flat(tree) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in mace.flat_items(tree)}


class StepHook:
    """Stands in the trainer's heartbeat slot: ``beat`` runs on the
    trainer's thread after every step."""

    def __init__(self, dev: harness.Device):
        self.dev = dev
        self.deadline = None       # window open while set
        self.profile_s = 0.0
        self.stretch = None
        self.stretch_steps = 0
        self.t_end = None
        self.beats = []            # the clock after each step of the window

    def beat(self, step: int, epoch: int = 0) -> bool:
        if self.deadline is None:
            return True
        self.beats.append(time.perf_counter())
        if self.stretch is not None:
            self.stretch_steps += 1
            if time.perf_counter() >= self.stretch.t0 + self.profile_s:
                self.stretch.stop()
                raise WindowClosed
            return True
        if time.perf_counter() < self.deadline:
            return True
        self.dev.sync()
        self.t_end = time.perf_counter()
        if self.profile_s:
            self.stretch = harness.Stretch(self.dev)
            self.stretch.start()
            return True
        raise WindowClosed


def run(ctx) -> Dict[str, Any]:
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.dev
    rcfg = mace.Config.from_fields(cfg)
    marks = [("start", time.perf_counter())]
    data = GraphSet(traffic["n_graphs"], ctx.seed, cfg["r_max"], traffic.get("max_atoms"),
                    traffic["size_seed"])
    marks.append(("graphs", time.perf_counter()))
    params = mace.init_params(rcfg, ctx.seed, dev.device)
    flat0 = flat(params)
    marks.append(("weights", time.perf_counter()))
    tcfg = TrainerConfig(
        capacity=traffic["capacity"], edge_factor=cfg["edge_factor"],
        max_graphs=traffic["max_graphs"], prefetch=traffic["prefetch"],
        engine="sequential", ckpt_dir=None, ckpt_every=0,
        **{f: traffic[f] for f in TRAIN_FIELDS})
    trainer = Trainer(mace_config(cfg), tcfg, data, seed=ctx.seed, params=params,
                      device=dev.device)
    marks.append(("trainer", time.perf_counter()))
    pulled = []  # (epoch, bin) in the order the trainer's feed took them
    step_iter = trainer.sampler.step_iter

    def recorded(state):
        for item in step_iter(state):
            pulled.append((state.epoch, item[0]))
            yield item

    trainer.sampler.step_iter = recorded
    hook = StepHook(dev)
    trainer.heartbeat = hook
    if ctx.fault is not None:
        ctx.fault(trainer)

    # set-up: the checked steps, through the window's own call and feed
    n_check = traffic["checked_steps"]
    losses = trainer.train(n_epochs=1, max_steps=1)["history"]
    adam = trainer.opt_state[1]
    grad1 = {k: v / (1 - optim.B1) for k, v in flat(adam["m"]).items()}
    losses += trainer.train(n_epochs=1, max_steps=n_check)["history"]
    prog = {"losses": [h["loss"] for h in losses], "grad": grad1,
            "params": flat(trainer.params), "ema": flat(trainer.ema_params)}
    dev.sync()
    marks.append(("checked steps", time.perf_counter()))
    setup_s = time.perf_counter() - ctx.t_start
    harness.note_setup(ctx.t_start, marks)

    hook.profile_s = traffic["profile_s"] if ctx.trace else 0.0
    t0 = time.perf_counter()
    hook.deadline = t0 + ctx.seconds
    try:
        trainer.train(n_epochs=10**9)
    except WindowClosed:
        pass
    steps = trainer.global_step
    peak = dev.peak_bytes()
    telemetry = trainer.telemetry
    n_window = steps - n_check - hook.stretch_steps
    done = pulled[:steps]
    del trainer, params, adam
    dev.free()

    bins = [b for _, b in done]
    real_atoms = [int(data.sizes[b].sum()) for b in bins]
    real_edges = [int(data.edges[b].sum()) for b in bins]
    window = slice(n_check, n_check + n_window)
    record = {
        "window_s": hook.t_end - t0,
        "atoms": real_atoms[window], "edges": real_edges[window],
        "wait_s": telemetry.host_wait[window],
        "capacity": tcfg.capacity, "edge_slots": tcfg.capacity * tcfg.edge_factor,
        "model_flops": [mcounts.TRAIN_FACTOR * mcounts.forward_flops(rcfg, a, e)
                        for a, e in zip(real_atoms[window], real_edges[window])],
        "peak_flops": kcounts.PEAKS["fp32_flops"],
    }
    if hook.stretch is not None:
        prof = hook.stretch.read(kcounts.SYMBOLS)
        stretch = slice(n_check + n_window, steps)
        n = max(len(bins[stretch]), 1)
        prof.update(steps=len(bins[stretch]),
                    mean_atoms=sum(real_atoms[stretch]) / n,
                    mean_edges=sum(real_edges[stretch]) / n)
        prof["kernel_share"] = kcounts.roofline_share(
            rcfg, prof["kernels"], prof["mean_atoms"], prof["mean_edges"])
        record["profile"] = prof

    # the reference, after the window, on the checked steps' bins
    t_ref = time.perf_counter()
    with mace.matmul_precision(tf32=False):
        ref = reference_steps(ctx, rcfg, flat0, data, bins[:n_check])
    step_ms = np.diff([t0] + hook.beats[:n_window]) * 1e3
    harness.note(f"window {record['window_s']:.3f} s, {n_window} steps; "
                 f"reference {time.perf_counter() - t_ref:.3f} s")
    harness.note("step ms " + " ".join(f"{x:.0f}" for x in step_ms) + "; collate ms "
                 + " ".join(f"{1e3 * x:.0f}" for x in telemetry.host_collate[window]))
    numbers = check.train_numbers(prog, ref, flat0)
    numbers["bad_bins"] = check.bad_bins(
        bins, [e for e, _ in done], data.sizes, data.edges, tcfg.capacity,
        tcfg.capacity * tcfg.edge_factor, tcfg.max_graphs)
    e2e = {"setup_s": setup_s,
           "train_atoms_per_s": sum(record["atoms"]) / record["window_s"],
           "train_peak_gib": peak / 2**30}
    finite = all(np.isfinite(x) for x in prog["losses"])
    return {"e2e": e2e, "record": record, "numbers": numbers, "peak_bytes": peak,
            "attempted": n_window, "failed": 0 if finite else n_window}


def reference_steps(ctx, rcfg, flat0, data, bins):
    """The reference's run of the checked steps on the graphs of ``bins``."""
    traffic = ctx.traffic
    return optim.train_steps(flat0, rcfg, [[data.get(i) for i in b] for b in bins],
                             {**{f: traffic[f] for f in TRAIN_FIELDS},
                              "max_graphs": traffic["max_graphs"]},
                             ctx.dev.device, traffic["reference_block_atoms"])
