"""End-to-end CFM training driver of the port (the paper's workload).

The synthetic Table-3-style dataset -> the Algorithm-1 balanced sampler (or
the fixed-count baseline, ``--sampler fixed``) -> numpy collation with the
edge blocking, prefetched on a thread -> MACE on the CUDA kernels ->
weighted energy + forces loss (a grad-of-grad) -> clip + AdamW + EMA ->
atomic checkpoints and resume.  Port of ``examples/train_mace_cfm.py`` on
the sequential engine, one rank:

    PYTHONPATH=src python -m repro_torch.launch.train_mace_cfm \\
        --steps 300 --n-graphs 2000 --capacity 512 --channels 32

The paper's configuration on the card: ``--channels 128 --capacity 3072
--correlation 2``.  ``--device cpu`` runs the kernels' plain PyTorch
versions on the CPU instead; without it the driver needs a CUDA card.
With ``--ckpt-dir`` the run checkpoints every 50 steps and at its end, and
resumes from the newest checkpoint there.  Data parallelism, with the
flags of ``examples/train_mace_cfm.py`` (engine names through
``bridge.JAX_ENGINE_NAMES``: ``shard_map`` -> ``data_parallel``):
``--engine`` (``sequential``, the one-process oracle over ``--n-ranks``
logical ranks; ``data_parallel`` or ``multihost``, one process per rank),
``--n-nodes`` (the two-level packing and the hierarchical reduction),
``--compress-grads`` (the int8 error-feedback all-reduce), and ``--nprocs
N``, which starts N copies of this command as one process group through
``launch.multihost.spawn_local`` (gloo on the CPU or when the ranks share
one card, else NCCL):

    PYTHONPATH=src python -m repro_torch.launch.train_mace_cfm --device cpu \
        --nprocs 2 --engine data_parallel --compress-grads --steps 3 \
        --n-graphs 16 --capacity 48 --channels 4 --max-atoms 24

Kernel selection, with the flags
of ``examples/train_mace_cfm.py`` under the port's names (``pallas`` ->
``cuda``, ``xla`` -> ``fused``): ``--impl`` (the symmetric contraction) and
``--interaction-impl`` (``ref`` | ``fused`` | ``cuda`` | registered, or
``auto``, the default as in the JAX example: impl, tile geometry and
backward from the tuning table for this run's shape bucket,
``kernels.autotune``; each decision is printed as an ``autotune:`` line),
``--bwd-impl`` (``cuda`` | ``fused``) and ``--precision`` (``fp32`` |
``bf16`` | ``fp8``: ``cuda`` becomes ``cuda_bf16`` / ``cuda_fp8``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-graphs", type=int, default=2000)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--correlation", type=int, default=2)
    ap.add_argument("--max-atoms", type=int, default=256)
    ap.add_argument("--sampler", choices=["balanced", "fixed"], default="balanced")
    ap.add_argument("--impl", default="cuda",
                    help="symmetric-contraction impl from kernels.registry "
                         "(ref | fused | cuda | registered), or 'auto' to "
                         "resolve from the tuning table")
    ap.add_argument("--interaction-impl", default="auto",
                    help="interaction (TP + scatter) impl from kernels.registry; "
                         "'auto' resolves impl + tile geometry + bwd from the "
                         "tuning table for this run's shape bucket; cuda reads "
                         "the edge blocking that collation builds for it")
    ap.add_argument("--bwd-impl", choices=["cuda", "fused"], default="cuda",
                    help="backward of the cuda interaction impls: cuda = the "
                         "gather + TP-transpose kernel, fused = the VJP of "
                         "the fused formulation")
    ap.add_argument("--precision", default=None, choices=["fp32", "bf16", "fp8"],
                    help="kernel operand precision: rewrites cuda impls to their "
                         "reduced-precision variants (sums stay fp32); refuses "
                         "impls without a variant rather than running fp32")
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "data_parallel", "multihost"])
    ap.add_argument("--n-ranks", type=int, default=0,
                    help="data-parallel ranks (bins per step); defaults to "
                         "--nprocs for data_parallel/multihost, else 1")
    ap.add_argument("--n-nodes", type=int, default=0,
                    help="pod nodes for the two-level packing and the "
                         "hierarchical reduction; must divide --n-ranks")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--nprocs", type=int, default=0,
                    help="start this many copies of this command as one "
                         "process group (one rank each)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group named by the REPRO_* env "
                         "vars (what --nprocs passes its children)")
    ap.add_argument("--prefetch", type=int, default=1,
                    help="collate lookahead depth (0 = inline, 1 = double buffering)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here and resume from it (none: no checkpoints)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default the CUDA card")
    args = ap.parse_args(argv)
    if args.nprocs and not args.distributed:
        return _spawn(args, argv)

    from repro_torch.core.mace import MaceConfig
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.train.train_loop import TrainerConfig

    cfg = MaceConfig(
        n_species=10, channels=args.channels, hidden_ls=(0, 1), sh_lmax=3,
        a_ls=(0, 1, 2, 3), correlation=args.correlation, n_interactions=2,
        avg_num_neighbors=12.0, impl=args.impl,
        interaction_impl=args.interaction_impl,
        interaction_bwd_impl=args.bwd_impl,
    )
    ds = SyntheticCFMDataset(args.n_graphs, seed=0, max_atoms=args.max_atoms)
    device = args.device
    if args.distributed:
        device = _join_group(args)
    n_ranks = args.n_ranks or (args.nprocs if args.engine != "sequential" else 1)
    tcfg = TrainerConfig(
        capacity=args.capacity, edge_factor=48,
        max_graphs=max(16, args.capacity // 8), lr=5e-3, ema_decay=0.99,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, prefetch=args.prefetch,
        precision=args.precision, engine=args.engine, n_ranks=n_ranks,
        n_nodes=args.n_nodes or None, compress_grads=args.compress_grads,
    )
    try:
        return _train(args, cfg, tcfg, ds, device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _spawn(args, argv) -> int:
    """Start ``args.nprocs`` copies of this command as one process group and
    wait for them; a failed child fails the run."""
    from repro_torch.launch.multihost import spawn_local

    if args.engine == "sequential":
        raise SystemExit("--nprocs needs --engine data_parallel or multihost: "
                         "the sequential engine runs in one process")
    argv = list(sys.argv[1:] if argv is None else argv)
    child = [sys.executable, "-m", "repro_torch.launch.train_mace_cfm", *argv,
             "--distributed"]
    codes = spawn_local(args.nprocs, child).wait()
    for i, c in enumerate(codes):
        print(f"process {i}: exit {c}")
    return max(abs(c) for c in codes)


def _join_group(args) -> str:
    """Join the process group of the REPRO_* env vars; returns this rank's
    device."""
    import torch

    from repro_torch.launch.multihost import (
        ENV_PROCESS_ID,
        choose_backend,
        initialize_distributed,
    )

    device = args.device or "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible; pass --device cpu")
        device = f"cuda:{int(os.environ[ENV_PROCESS_ID]) % torch.cuda.device_count()}"
    backend = choose_backend(device, args.nprocs)
    initialize_distributed(backend=backend)
    print(f"rank {torch.distributed.get_rank()}/{args.nprocs}: backend {backend}, "
          f"device {device}", flush=True)
    return device


def _train(args, cfg, tcfg, ds, device) -> int:
    from repro_torch.core.mace import param_count
    from repro_torch.train.train_loop import Trainer

    tr = Trainer(cfg, tcfg, ds, sampler=args.sampler, seed=0, device=device)
    if tr.maybe_restore():
        print(f"resumed from step {tr.global_step}")
    print(f"params={param_count(tr.params):,} graphs={len(ds)} "
          f"steps/epoch={tr.sampler.steps_per_epoch()} sampler={args.sampler} "
          f"engine={tcfg.engine} ranks={tcfg.n_ranks} nodes={tcfg.n_nodes} "
          f"compress={tcfg.compress_grads} prefetch={tcfg.prefetch} "
          f"impl={tr.mace_cfg.symcon_impl_name} "
          f"interaction={tr.mace_cfg.interaction_impl_name} "
          f"bwd={tr.mace_cfg.interaction_bwd_impl} device={tr.device}")
    for d in tr.autotune_decisions.values():
        print(f"autotune: {d.describe()}")

    t0 = time.perf_counter()
    hist = tr.train(n_epochs=1_000_000, max_steps=args.steps)["history"]
    dt = time.perf_counter() - t0
    if hist:
        k = max(1, len(hist) // 10)
        for i in range(0, len(hist), k):
            h = hist[i]
            print(f"step {i:5d}  loss={h['loss']:.4f}  e_rmse={h['e_rmse']:.4f}  "
                  f"f_rmse={h['f_rmse']:.4f}")
        print(f"final loss={hist[-1]['loss']:.4f}  ({len(hist)} steps in {dt:.1f}s, "
              f"{len(hist) / dt:.2f} steps/s)")
    tel = tr.telemetry
    if tel.n_steps:
        skip = 1 if tel.n_steps > 1 else 0   # the first step builds the kernels
        print(f"telemetry: c_token={tel.c_token(skip):.3e}s/atom "
              f"straggler_measured={tel.measured_straggler(skip):.3f}")
        print(f"prefetch: depth={tcfg.prefetch} overlap={tel.overlap_seconds(skip):.3f}s "
              f"({100 * tel.overlap_fraction(skip):.0f}% of host collate hidden) "
              f"edge_blocking={tel.blocking_seconds(skip):.3f}s")
    if tcfg.ckpt_dir:
        print("checkpoint at", tcfg.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
