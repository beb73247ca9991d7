"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card (no measured window is needed):

* ``program``: the numbers of sound runs of the program, one per seed;
* ``control``: the reference computed in TF32 put in the program's place,
  against the reference in float32, on the same inputs;
* ``half_batch`` (training cells): the program with half of each bin left
  out and the mean taken over the rest.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] [--out FILE]

Each reading is one JSON line on standard output (and in ``FILE``).  The
limits in ``limits/<cell>.json`` lie between the largest program reading
and the smallest control or fault reading, as ``PERF.md`` records.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness, run  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def half_batch(trainer):
    collate = trainer.engine.collate
    trainer.engine.collate = lambda mols, shape: collate(
        [m[: max(len(m) // 2, 1)] for m in mols], shape)


def control(ctx, mix, seed):
    """The reference in TF32 against the reference in float32 on the
    inputs of ``seed`` (the bins the port's sampler makes of them, or a
    sample of the serving pool with its largest graph)."""
    import numpy as np

    from perfbench.datagen import GraphSet
    from perfbench.reference import check, mace

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.dev
    rcfg = mace.Config.from_fields(cfg)
    params = mace.init_params(rcfg, seed, dev.device)
    if traffic["mix"] == "train_bins":
        from repro_torch.data.sampler import BalancedBatchSampler, SamplerState

        data = GraphSet(traffic["n_graphs"], seed, cfg["r_max"], traffic.get("max_atoms"),
                        traffic["size_seed"])
        sampler = BalancedBatchSampler(data.sizes, traffic["capacity"], 1, seed=seed)
        steps = sampler.step_iter(SamplerState(0, 0))
        bins = [next(steps)[0] for _ in range(traffic["checked_steps"])]
        flat0 = dict(mace.flat_items(params))
        out = {}
        for tf32 in (False, True):
            with mace.matmul_precision(tf32):
                out[tf32] = mix.reference_steps(ctx, rcfg, flat0, data, bins)
        return check.train_numbers(out[True], out[False], flat0)
    pool = GraphSet(traffic["pool"], seed, cfg["r_max"], traffic.get("max_atoms"),
                    traffic["size_seed"])
    rng = np.random.default_rng((seed, 11))
    pick = set(rng.choice(len(pool), size=traffic["checked_requests"], replace=False).tolist())
    mols = [pool.get(i) for i in sorted(pick | {int(np.argmax(pool.sizes))})]
    out = {}
    for tf32 in (False, True):
        with mace.matmul_precision(tf32):
            out[tf32] = mix.reference_answers(params, rcfg, mols, traffic, dev)
    return check.serve_numbers(out[True][0], out[True][1], out[False][0], out[False][1],
                               [m.n_atoms for m in mols])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.prepare_environment()
    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    dev = harness.Device(harness.require_cards(cell["chips"]))
    config = harness.data_file("configs", cell["config"])
    traffic = harness.data_file("traffic", cell["traffic"])
    mix = harness.module("mixes", traffic["mix"])
    sink = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"cell": cell["name"], "kind": kind, "seed": seed,
                           "numbers": numbers, **extra})
        print(line, flush=True)
        if sink:
            print(line, file=sink, flush=True)

    def ctx(seed, fault=None):
        return run.Context(seed, args.seconds, False, config, traffic, dev,
                           time.perf_counter(), fault)

    for seed in args.seeds:
        out = mix.run(ctx(seed))
        emit("program", seed, out["numbers"], e2e=out["e2e"])
    for seed in args.control_seeds:
        emit("control", seed, control(ctx(seed), mix, seed))
    for seed in args.fault_seeds:
        emit("half_batch", seed, mix.run(ctx(seed, half_batch))["numbers"])
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
