"""Kernel timing harness, command line: each (kind, impl) forward, and
forward plus first-order backward, per shape, appended to the autotuner's
trajectory (``kernels/bench_kernels.json``; the harness itself is
``repro_torch.kernels.bench``):

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels --grad --quick --device cpu
    python -m repro_torch.launch.bench_kernels --grad          # on the CUDA card
    PYTHONPATH=src python -m repro_torch.launch.bench_kernels --capabilities
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.bridge import resolve_device
from repro_torch.kernels.autotune import DEFAULT_TRAJECTORY_PATH
from repro_torch.kernels.bench import (
    KEEP_PER_KEY, MAX_TRAJECTORY_RUNS, bench_matrix, write_bench_json,
)
from repro_torch.kernels.registry import KINDS, capabilities


def main(argv=()):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grad", action="store_true",
                    help="also time forward + first-order backward (fwd_bwd rows)")
    ap.add_argument("--quick", action="store_true", help="small problem sizes")
    ap.add_argument("--impls", default="",
                    help="comma-separated impl names (default: ref,fused,cuda; "
                         "on the CPU cuda only at --quick sizes)")
    ap.add_argument("--json", default=str(DEFAULT_TRAJECTORY_PATH),
                    help="trajectory path (default: the autotuner's)")
    ap.add_argument("--no-json", action="store_true", help="skip writing the trajectory")
    ap.add_argument("--precisions", default="",
                    help="comma-separated reduced precisions (bf16,fp8): also "
                         "bench the cuda_<p> variants")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--max-runs", type=int, default=MAX_TRAJECTORY_RUNS)
    ap.add_argument("--keep-per-key", type=int, default=KEEP_PER_KEY,
                    help="newest runs kept per (backend, quick, grad) key")
    ap.add_argument("--capabilities", action="store_true",
                    help="print the registry's capability matrix as JSON and exit")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions on the CPU; default the CUDA card")
    args = ap.parse_args(list(argv))

    if args.capabilities:
        print(json.dumps({kind: capabilities(kind) for kind in KINDS}, indent=1))
        return []

    dev = resolve_device(args.device)
    impls = tuple(s for s in args.impls.split(",") if s)
    if not impls:
        impls = ("ref", "fused", "cuda")
        if dev.type == "cpu" and not args.quick:
            # full-size plain-version timings of the cuda impls mean nothing
            impls = ("ref", "fused")
    impls += tuple(f"cuda_{p}" for p in args.precisions.split(",") if p)
    matrix = bench_matrix(grad=args.grad, quick=args.quick, impls=impls,
                          repeats=args.repeats, device=dev)
    rows = []
    for r in matrix:
        us = "failed" if r["us"] is None else f"{r['us']:.3f}"
        rows.append(f"kernel_{r['kind']}_{r['impl']}_{r['mode']},{us},"
                    + ",".join(f"{k}={v}" for k, v in r["params"].items()))
    if not args.no_json:
        write_bench_json(matrix, args.json, grad=args.grad, quick=args.quick, device=dev,
                         max_runs=args.max_runs, keep_per_key=args.keep_per_key)
        rows.append(f"bench_json,written={args.json},rows={len(matrix)}")
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
