"""Cluster training entry point of the port: MACE CFM, one process per rank.

The counterpart of the JAX package's ``launch/train.py``.  A cluster's
launcher starts this module once per rank with ``--distributed`` and the
rendezvous (``--coordinator --num-processes --process-id``, or the
``REPRO_*`` env vars); on one machine ``launch.multihost`` starts the ranks
and sets those vars:

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100
    PYTHONPATH=src python -m repro_torch.launch.multihost --nprocs 2 -- \\
        python -m repro_torch.launch.train --distributed --device cpu \\
        --reduced --steps 5 --compress-grads

Each rank takes its bin of the Algorithm-1 packing (two-level with
``--n-nodes``), runs MACE forward and backward (on the CUDA kernels unless
``--device cpu``), averages the gradients with ``torch.distributed``
(plain, or int8 with error feedback by ``--compress-grads``; flat, or node
then device with ``--n-nodes``), steps AdamW on replicated parameters and
checkpoints through the multi-process atomic commit; a restart with the
same world size resumes.  A distributed run uses the ``data_parallel``
engine, or ``multihost`` when ``--n-nodes`` is given, with one rank per
process, unless ``--engine`` says otherwise.  The backend is ``nccl`` when
every rank has a card of its own and ``gloo`` otherwise (CPU ranks, or
several ranks on one card); the choice is printed.

Not ported: the LM architectures (``--arch``), ``--supervised`` and
``--elastic`` (the resilience and elastic slices).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
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
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs.mace_cfm import CONFIG, REDUCED
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

    cfg = REDUCED if args.reduced else CONFIG
    cap = 256 if args.reduced else 3072
    ds = SyntheticCFMDataset(2000 if args.reduced else 100_000, seed=0,
                             max_atoms=cap // 4 if args.reduced else None)
    tcfg = TrainerConfig(capacity=cap, edge_factor=32, max_graphs=max(16, cap // 8),
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         compress_grads=args.compress_grads, **extra)
    try:
        tr = Trainer(cfg, tcfg, ds, seed=0, device=device)
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
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
