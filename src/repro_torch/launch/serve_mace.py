"""Continuous-batching MACE serving on the port: clients, skewed load, fault drill.

    PYTHONPATH=src python -m repro_torch.launch.serve_mace --requests 48
    PYTHONPATH=src python -m repro_torch.launch.serve_mace --kill-worker
    PYTHONPATH=src python -m repro_torch.launch.serve_mace --config paper --kill-worker
    PYTHONPATH=src python -m repro_torch.launch.serve_mace --device cpu --kill-worker

Port of ``examples/serve_mace.py``, with its flags and defaults.  Starts a
``repro_torch.serve.GraphServer`` (on the card every bucket of the ladder is
warmed and captured as one CUDA graph at startup), then plays a skewed-size
request mix (hub molecules of the large tail interleaved with waves of
small ones) from a handful of client threads.  Prints per-request samples,
the latency and throughput summary, the per-bucket batching evidence and
the bucket census (graphs captured per bucket: 1 on the card, ragged tails
included; 0 on the CPU, which serves eagerly), then one ``summary`` JSON
line.  ``--kill-worker`` arms a worker fault before the load starts (the
JAX example arms it 0.2 s in, when on the card the whole mix may already
be served), and the watchdog's drain-and-rebuild serves every request
anyway; ``REPRO_FAULT_PLAN='{"serve_worker_fault": {}}'`` arms the same
drill from the environment.  With either, the run waits for the rebuild
and checks the census of the rebuilt engine.

Added flags: ``--device`` (default the CUDA card; ``cpu`` runs the
kernels' plain versions), ``--impl`` / ``--interaction-impl`` /
``--precision`` as in ``launch/train_mace_cfm.py`` (``--impl`` defaults
to ``cuda``, ``--interaction-impl`` to ``auto`` as in the JAX example:
the server resolves it from the tuning table at the largest bucket and
prints each decision as an ``autotune:`` line), and ``--config``:
``example`` is the JAX example's widths, ``paper`` the paper's
(``configs/mace_cfm.py`` ``CONFIG``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import threading
import time

WAIT_REBUILD_S = 60.0


def build_config(args):
    from repro_torch.configs.mace_cfm import CONFIG
    from repro_torch.core.mace import MaceConfig

    kernels = dict(impl=args.impl, interaction_impl=args.interaction_impl,
                   precision=args.precision)
    if args.config == "paper":
        return dataclasses.replace(CONFIG, **kernels)
    return MaceConfig(
        n_species=10, channels=8, hidden_ls=(0, 1), sh_lmax=2, a_ls=(0, 1, 2),
        correlation=2, n_interactions=2, avg_num_neighbors=10.0, **kernels,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--hub-frac", type=float, default=0.2)
    ap.add_argument("--capacities", default="64,128")
    ap.add_argument("--kill-worker", action="store_true",
                    help="fault drill: kill a worker under load and heal")
    ap.add_argument("--config", choices=["example", "paper"], default="example")
    ap.add_argument("--impl", default="cuda",
                    help="symmetric-contraction impl from kernels.registry "
                         "(ref | fused | cuda | registered), or 'auto'")
    ap.add_argument("--interaction-impl", default="auto",
                    help="interaction (TP + scatter) impl from kernels.registry, "
                         "or 'auto' to resolve it from the tuning table")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "fp8"],
                    help="kernel operand precision: rewrites cuda impls to their "
                         "reduced-precision variants (sums stay fp32)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; default the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.mace import init_mace, param_count
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.resilience.faults import FaultPlan
    from repro_torch.serve import GraphServer, ServeConfig, bucket_key

    cfg = build_config(args)
    params = init_mace(cfg, torch.Generator().manual_seed(0))
    capacities = tuple(int(c) for c in args.capacities.split(","))
    ds = SyntheticCFMDataset(256, seed=1, max_atoms=max(capacities))
    print(f"MACE params: {param_count(params):,}; bucket ladder: {capacities}; "
          f"config {args.config}")

    t0 = time.perf_counter()
    server = GraphServer(
        cfg, params,
        ServeConfig(capacities=capacities, n_workers=args.workers,
                    max_wait_s=0.01, watchdog_s=0.2),
        device=args.device,
    )
    on_card = server.device.type == "cuda"
    print(f"warm start ({len(server.buckets)} buckets "
          f"{'captured' if on_card else 'warmed eagerly'}) on {server.device} "
          f"in {time.perf_counter() - t0:.1f}s; impl {server.mace_cfg.symcon_impl_name}, "
          f"interaction {server.mace_cfg.interaction_impl_name}")
    for d in server.autotune_decisions.values():
        print(f"autotune: {d.describe()}")

    # skewed request mix: hubs from the large tail, the rest small
    by_size = sorted(range(len(ds)), key=lambda i: int(ds.sizes[i]))
    hub_pool, small_pool = by_size[-32:], by_size[:128]
    rng = random.Random(0)
    picks = [
        rng.choice(hub_pool if rng.random() < args.hub_frac else small_pool)
        for _ in range(args.requests)
    ]
    per_client = [picks[c::args.clients] for c in range(args.clients)]

    drill = args.kill_worker or FaultPlan.from_env().serve_worker_fault()
    if args.kill_worker:
        wid = server.inject_worker_fault()
        print(f"fault drill: injected failure into worker {wid} "
              "(watchdog will drain-and-rebuild)")

    futures, flock = [], threading.Lock()

    def client(my_picks):
        for i in my_picks:
            f = server.submit(ds.get(i), timeout=30.0)
            with flock:
                futures.append(f)
            time.sleep(0.001)  # a trickle, so waves form and mix

    threads = [
        threading.Thread(target=client, args=(p,)) for p in per_client
    ]
    t_clients = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [f.result(timeout=300.0) for f in futures]
    # the clients' rate: from their first submission to the last result
    clients_s = time.perf_counter() - t_clients
    graphs_per_s = len(results) / clients_s
    if drill:
        deadline = time.monotonic() + WAIT_REBUILD_S
        while not server.rebuild_events and time.monotonic() < deadline:
            time.sleep(0.05)

    print(f"\nserved {len(results)} requests; samples:")
    for r in results[:4]:
        print(f"  E={r.energy:+.3f}  atoms={len(r.forces)}  "
              f"bucket={r.bucket}  copacked={r.n_copacked}  "
              f"latency={r.latency_s * 1e3:.0f}ms  worker={r.worker}")

    s = server.stats()
    print(f"\nthroughput: {graphs_per_s:.1f} graphs/s over {clients_s:.2f} s   "
          f"latency p50/p99: {s['latency_p50_ms']:.0f}/"
          f"{s['latency_p99_ms']:.0f} ms")
    print(f"bucket bins: {s['bucket_bins']}")
    print(f"compile census (graphs captured per bucket; 1 = no recapture): "
          f"{s['compile_census']}")
    for w in s["workers"]:
        print(f"  worker {w['worker']}: alive={w['alive']} "
              f"bins={w['served_bins']} graphs={w['served_graphs']} "
              f"busy={w['busy_s']:.2f}s")
    if server.rebuild_events:
        print(f"fleet rebuilds: {server.rebuild_events}")
    print("summary " + json.dumps({
        "device": str(server.device), "requests": args.requests,
        "served": s["served"], "failed": s["failed"], "rebuilds": s["rebuilds"],
        "compile_census": s["compile_census"],
        "graphs_per_s": graphs_per_s, "latency_p50_ms": s["latency_p50_ms"],
        "latency_p99_ms": s["latency_p99_ms"]}))
    want = 1 if on_card else 0
    server.close()
    if s["served"] != args.requests or s["failed"]:
        raise SystemExit(f"served {s['served']} of {args.requests}, {s['failed']} failed")
    if drill and not s["rebuilds"]:
        raise SystemExit(f"the fault drill did not rebuild the fleet within "
                         f"{WAIT_REBUILD_S:.0f}s")
    census = s["compile_census"]
    if sorted(census) != sorted(map(bucket_key, server.buckets)) or any(
            v != want for v in census.values()):
        raise SystemExit(f"compile census {census}: expected {want} per bucket")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
