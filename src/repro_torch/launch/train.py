"""Cluster training entry point of the port: MACE CFM (or another MACE
configuration of ``repro_torch.configs``, ``--config``), one process per rank.

The counterpart of the JAX package's ``launch/train.py``.  A cluster's
launcher starts this module once per rank with ``--distributed`` and the
rendezvous (``--coordinator --num-processes --process-id``, or the
``REPRO_*`` env vars); on one machine ``launch.multihost`` starts the ranks
and sets those vars:

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --config mace_mp0_large
    PYTHONPATH=src python -m repro_torch.launch.multihost --nprocs 2 -- \\
        python -m repro_torch.launch.train --distributed --device cpu \\
        --reduced --steps 5 --compress-grads

Each rank takes its bin of the Algorithm-1 packing (two-level with
``--n-nodes``), runs MACE forward and backward (on the CUDA kernels unless
``--device cpu``), averages the gradients with ``torch.distributed``
(plain, or int8 with error feedback by ``--compress-grads``; flat, or node
then device with ``--n-nodes``), steps AdamW on replicated parameters and
checkpoints through the multi-process atomic commit; a restart with the
same world size resumes, and one at another world size resumes with
``--elastic`` (the epoch remainder re-packed for the new rank count, the
error-feedback residuals re-initialised).  A distributed run uses the
``data_parallel`` engine, or ``multihost`` when ``--n-nodes`` is given,
with one rank per process, unless ``--engine`` says otherwise.  The backend is ``nccl`` when
every rank has a card of its own and ``gloo`` otherwise (CPU ranks, or
several ranks on one card); the choice is printed.

``--interaction-impl`` defaults to ``auto``, as the JAX config's
``interaction_impl`` does: the trainer resolves it from the tuning table
for this run's shape bucket and each decision is printed as an
``autotune:`` line; ``--impl`` overrides the config's contraction impl
(``auto`` too).

Supervised pods (``--distributed --supervised``): this process becomes a
``resilience.PodSupervisor`` parent instead of a trainer.  It spawns
``--nprocs`` copies of this same command (without ``--supervised``, with
``--distributed --elastic``) as one process group, watches their exit codes
and per-step heartbeats, and on a crash or a hang kills the group and
relaunches it one process smaller from the newest committed checkpoint,
within ``--max-restarts``.  A ``REPRO_FAULT_PLAN`` set on the parent arms
the first attempt only.  ``--step-deadline-s`` arms each child's step
watchdog (a hung step exits 44, which the supervisor records as a hang);
``incidents.jsonl``, the heartbeats and the children's logs go to
``--run-dir`` (default ``<ckpt-dir>/supervisor``):

    PYTHONPATH=src python -m repro_torch.launch.train --distributed \
        --supervised --nprocs 2 --device cpu --reduced --steps 4 \
        --ckpt-every 1 --ckpt-dir run
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--config", default="mace_cfm",
                    help="the MACE configuration of repro_torch.configs to train")
    ap.add_argument("--reduced", action="store_true",
                    help="run the reduced config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here and resume from it (none: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default the CUDA card")
    ap.add_argument("--distributed", action="store_true",
                    help="join a multi-process group (see --coordinator)")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (or env REPRO_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="world size (or env REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (or env REPRO_PROCESS_ID)")
    ap.add_argument("--engine", default=None,
                    choices=["sequential", "data_parallel", "multihost"],
                    help="engine override")
    ap.add_argument("--n-nodes", type=int, default=None,
                    help="node count of the n_nodes x devices_per_node ranks")
    ap.add_argument("--n-ranks", type=int, default=None,
                    help="total data-parallel ranks")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--impl", default=None,
                    help="symmetric-contraction impl, or 'auto' (default: the config's)")
    ap.add_argument("--interaction-impl", default="auto",
                    help="interaction impl, or 'auto' (the default, as the JAX "
                         "config's): resolved from the tuning table")
    ap.add_argument("--elastic", action="store_true",
                    help="allow restoring a checkpoint written at another "
                         "rank or process count (implied for supervised "
                         "relaunches)")
    ap.add_argument("--supervised", action="store_true",
                    help="run as a PodSupervisor parent: spawn --nprocs "
                         "children of this command, watch heartbeats and "
                         "exit codes, restart elastically on failure")
    ap.add_argument("--nprocs", type=int, default=2,
                    help="supervised pod world size (parent only)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="supervisor restart budget before failing loudly")
    ap.add_argument("--heartbeat-deadline-s", type=float, default=60.0,
                    help="the supervisor declares a hang when a child's "
                         "newest heartbeat is older than this")
    ap.add_argument("--step-deadline-s", type=float, default=None,
                    help="StepWatchdog deadline per training step (a hung "
                         "step exits 44 for the supervisor)")
    ap.add_argument("--run-dir", default=None,
                    help="supervisor state dir (incidents.jsonl, heartbeats, "
                         "child logs); default <ckpt-dir>/supervisor")
    args = ap.parse_args(argv)
    if args.supervised:
        return _supervise(args, sys.argv[1:] if argv is None else list(argv))

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_edge_factor, get_reduced
    from repro_torch.core.mace import MaceConfig
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    device = args.device or "cuda"
    extra = {}
    if args.distributed:
        import os

        import torch

        from repro_torch.launch.multihost import (
            ENV_NUM_PROCESSES,
            ENV_PROCESS_ID,
            choose_backend,
            initialize_distributed,
        )

        n_procs = args.num_processes or int(os.environ.get(ENV_NUM_PROCESSES, "1"))
        proc = args.process_id if args.process_id is not None else int(
            os.environ.get(ENV_PROCESS_ID, "0"))
        backend = choose_backend(device, n_procs)
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA card is visible; pass --device cpu")
            device = f"cuda:{proc % torch.cuda.device_count()}"
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, backend=backend)
        print(f"distributed: process {dist.get_rank()}/{dist.get_world_size()}, "
              f"backend {backend}, device {device}", flush=True)
        extra["engine"] = "multihost" if args.n_nodes else "data_parallel"
        extra["n_ranks"] = dist.get_world_size()
    if args.engine is not None:
        extra["engine"] = args.engine
    if args.n_ranks is not None:
        extra["n_ranks"] = args.n_ranks
    if args.n_nodes is not None:
        extra["n_nodes"] = args.n_nodes

    cfg = get_reduced(args.config) if args.reduced else get_config(args.config)
    if not isinstance(cfg, MaceConfig):
        ap.error(f"--config {args.config} is not a MACE configuration")
    cap = 256 if args.reduced else 3072
    ds = SyntheticCFMDataset(2000 if args.reduced else 100_000, seed=0, r_cutoff=cfg.r_max,
                             max_atoms=cap // 4 if args.reduced else None)
    tcfg = TrainerConfig(capacity=cap, edge_factor=get_edge_factor(args.config),
                         max_graphs=max(16, cap // 8),
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         compress_grads=args.compress_grads, impl=args.impl,
                         interaction_impl=args.interaction_impl, elastic=args.elastic,
                         step_deadline_s=args.step_deadline_s, **extra)
    try:
        tr = Trainer(cfg, tcfg, ds, seed=0, device=device)
        for d in tr.autotune_decisions.values():
            print(f"autotune: {d.describe()}")
        if tr.maybe_restore():
            print(f"resumed at step {tr.global_step}")
        start = tr.global_step
        hist = tr.train(n_epochs=10**9, max_steps=args.steps)["history"]
        for i, h in enumerate(hist):
            if i % tcfg.log_every == 0 or i == len(hist) - 1:
                print(f"step {start + i}: loss {h['loss']:.4f}")
        tel = tr.telemetry
        final = f", final loss {hist[-1]['loss']:.4f}" if hist else ""
        print(f"done: {len(hist)} steps, engine {tr.engine.name}, ranks "
              f"{tr.engine.n_ranks}{final}, measured straggler "
              f"{tel.measured_straggler(1 if tel.n_steps > 1 else 0):.3f}")
        print(f"kernel launches: {json.dumps(kernel_launches())}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def kernel_launches():
    """Each CUDA kernel's launches in this process so far (0 on the CPU,
    where the wrappers run their plain versions)."""
    from repro_torch.kernels.channelwise_tp import kernel as tpk
    from repro_torch.kernels.symmetric_contraction import kernel as sck

    return {"symcon_fwd": sck.SYMCON_FWD.launches, "symcon_bwd": sck.SYMCON_BWD.launches,
            "tp_scatter_fwd": tpk.TP_SCATTER_FWD.launches,
            "tp_gather_bwd": tpk.TP_GATHER_BWD.launches,
            "symcon_dbl": sck.SYMCON_DBL.launches,
            "tp_dbl_scatter": tpk.TP_DBL_SCATTER.launches,
            "tp_dbl_gather": tpk.TP_DBL_GATHER.launches}


def _supervise(args, argv) -> int:
    """The ``--supervised`` parent: a ``PodSupervisor`` over ``--nprocs``
    children of this command."""
    from repro_torch.resilience import FaultPlan, PodSupervisor, SupervisorConfig

    if not args.ckpt_dir:
        raise SystemExit("--supervised needs --ckpt-dir: a relaunched pod "
                         "resumes from the newest checkpoint there")
    # children run THIS command without --supervised, with --distributed
    # and --elastic: a degraded relaunch restores across process counts
    child = [sys.executable, "-m", "repro_torch.launch.train"] + [
        a for a in argv if a != "--supervised"]
    for needed in ("--distributed", "--elastic"):
        if needed not in child:
            child.append(needed)
    run_dir = args.run_dir or os.path.join(args.ckpt_dir, "supervisor")
    sup = PodSupervisor(
        child,
        SupervisorConfig(n_procs=args.nprocs,
                         heartbeat_deadline_s=args.heartbeat_deadline_s,
                         max_restarts=args.max_restarts),
        run_dir,
        # a fault plan armed on the parent arms attempt 0 only: relaunches
        # get it stripped, so an injected fault cannot fire forever
        fault_plan=FaultPlan.from_env(),
        env={"PYTHONPATH": os.environ.get("PYTHONPATH", "")},
    )
    summary = sup.run()
    print(f"supervised pod done: attempts={summary['attempts']} "
          f"restarts={summary['restarts']} final world={summary['world_size_final']} "
          f"incidents={summary['incidents_path']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
