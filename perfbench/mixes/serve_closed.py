"""Closed-loop serving: ``clients`` callers that each send their next
molecule the moment the last one's energy and forces come back, as
molecular-dynamics codes and screening workers do, through the port's
``GraphServer``.

Set-up draws the pool of graphs and the weights from the seed, builds the
server (which captures one CUDA graph per bucket of the ladder) and runs
the loop for ``warm_requests`` requests.  The window then runs the same
loop for ``--seconds``; with ``--trace 1`` it runs on for ``profile_s``
under the profiler.  One client thread keeps every client's request in
flight and sees each result as it lands; the molecule of each submission is
the next of one stream drawn from the seed, so the molecules of the first
n submissions are the same whatever the timing.

``serve_graphs_per_s`` is the requests completed in the window over the
window; ``serve_latency_p99_ms`` the 99th percentile of their latency from
``submit`` to the result in the client's hand (a failed request counts as
beyond every limit).
"""
from __future__ import annotations

import time
from concurrent.futures import FIRST_COMPLETED, wait
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import harness
from perfbench.counts import kernels as kcounts
from perfbench.counts import model as mcounts
from perfbench.datagen import GraphSet
from perfbench.mixes.train_bins import flat, mace_config
from perfbench.reference import check, mace

DRAIN_S = 60.0       # how long results due in the window may come late
FAILED_MS = 1e18     # the latency a failed request counts as


def run(ctx) -> Dict[str, Any]:
    from repro_torch.serve import GraphServer, ServeConfig, bucket_key

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.dev
    rcfg = mace.Config.from_fields(cfg)
    marks = [("start", time.perf_counter())]
    pool = GraphSet(traffic["pool"], ctx.seed, cfg["r_max"], traffic.get("max_atoms"),
                    traffic["size_seed"])
    marks.append(("graphs", time.perf_counter()))
    params = mace.init_params(rcfg, ctx.seed, dev.device)
    ref_params = mace.nest(flat(params))
    marks.append(("weights", time.perf_counter()))
    scfg = ServeConfig(capacities=tuple(traffic["ladder"]), edge_factor=cfg["edge_factor"],
                       n_workers=traffic["workers"], max_wait_s=traffic["max_wait_s"])
    server = GraphServer(mace_config(cfg), params, scfg, device=dev.device)
    if ctx.fault is not None:
        ctx.fault(server)
    marks.append(("server and captures", time.perf_counter()))
    capacity = {bucket_key(b): b.max_nodes for b in server.buckets}
    stream = np.random.default_rng((ctx.seed, 7)).integers(0, len(pool), size=1 << 22)
    done: List[tuple] = []    # (molecule, t_submit, t_done, result or None)
    outstanding: Dict[Any, tuple] = {}
    nxt = 0

    def submit():
        nonlocal nxt
        i = int(stream[nxt])
        nxt += 1
        outstanding[server.submit(pool.get(i))] = (i, time.perf_counter())

    def loop(until, n_done=None):
        """Keep every client busy until ``until`` (or until ``n_done`` more
        results); a client whose result lands after that sends no more.
        Returns once ``until`` has passed, or with ``n_done`` once every
        request has come back."""
        goal = None if n_done is None else len(done) + n_done
        while outstanding:
            finished, _ = wait(list(outstanding), timeout=DRAIN_S, return_when=FIRST_COMPLETED)
            if not finished:
                return
            now = time.perf_counter()
            for f in finished:
                i, t_sub = outstanding.pop(f)
                done.append((i, t_sub, now, f.result() if f.exception() is None else None))
                if now < until and (goal is None or len(done) < goal):
                    submit()
            if goal is None and now >= until:
                return

    try:
        for _ in range(traffic["clients"]):
            submit()
        loop(float("inf"), traffic["warm_requests"])  # warm-up, drained
        n_warm = len(done)
        for _ in range(traffic["clients"]):
            submit()
        dev.sync()
        t0 = time.perf_counter()
        marks.append(("warm-up requests", t0))
        setup_s = t0 - ctx.t_start
        harness.note_setup(ctx.t_start, marks)
        bins0 = dict(server.stats()["bucket_bins"])
        loop(t0 + ctx.seconds)
        bins1 = dict(server.stats()["bucket_bins"])
        stretch = None
        if ctx.trace:
            while len(outstanding) < traffic["clients"]:
                submit()
            stretch = harness.Stretch(dev)
            stretch.start()
            loop(time.perf_counter() + traffic["profile_s"])
            stretch.stop()
            bins2 = dict(server.stats()["bucket_bins"])
        loop(0.0, n_done=0)  # no more submissions: the rest come back
        lost = len(outstanding)
    finally:
        server.close(drain=False)
    peak = dev.peak_bytes()
    del server, params
    dev.free()

    t1 = t0 + ctx.seconds
    window = [d for d in done[n_warm:] if t0 <= d[2] <= t1]
    served = [d for d in window if d[3] is not None]
    lat_ms = [(d[2] - d[1]) * 1e3 if d[3] is not None else FAILED_MS for d in window]
    atoms = sum(int(pool.sizes[d[0]]) for d in served)
    n_bins = {k: bins1.get(k, 0) - bins0.get(k, 0) for k in bins1}
    record = {
        "window_s": ctx.seconds,
        "atoms": atoms,
        "bin_atoms": sum(n * capacity[k] for k, n in n_bins.items()),
        "model_flops": sum(mcounts.SERVE_FACTOR * mcounts.forward_flops(
            rcfg, int(pool.sizes[d[0]]), int(pool.edges[d[0]])) for d in served),
        "peak_flops": kcounts.PEAKS["fp32_flops"],
    }
    if stretch is not None:
        prof = stretch.read(kcounts.SYMBOLS)
        in_stretch = [d for d in done if stretch.t0 <= d[2] <= stretch.t1 and d[3] is not None]
        bins = max(sum(bins2.get(k, 0) - bins1.get(k, 0) for k in bins2), 1)
        prof.update(bins=bins,
                    mean_atoms=sum(int(pool.sizes[d[0]]) for d in in_stretch) / bins,
                    mean_edges=sum(int(pool.edges[d[0]]) for d in in_stretch) / bins)
        prof["kernel_share"] = kcounts.roofline_share(
            rcfg, prof["kernels"], prof["mean_atoms"], prof["mean_edges"])
        record["profile"] = prof

    # the reference, after the window, on a sample of the window's results
    rng = np.random.default_rng((ctx.seed, 11))
    k = min(traffic["checked_requests"], len(served))
    pick = sorted(set(rng.choice(len(served), size=k, replace=False).tolist())
                  | {int(np.argmax([pool.sizes[d[0]] for d in served]))}) if served else []
    sample = [served[j] for j in pick]
    mols = [pool.get(d[0]) for d in sample]
    t_ref = time.perf_counter()
    with mace.matmul_precision(tf32=False):
        ref_e, ref_f = reference_answers(ref_params, rcfg, mols, traffic, dev)
    harness.note(f"window {ctx.seconds:.3f} s, {len(window)} requests; reference "
                 f"{time.perf_counter() - t_ref:.3f} s for {len(mols)} molecules")
    per_s = np.bincount([int(d[2] - t0) for d in served], minlength=int(ctx.seconds))
    harness.note("completed per second " + " ".join(str(n) for n in per_s))
    numbers = check.serve_numbers(
        [d[3].energy for d in sample],
        np.concatenate([d[3].forces for d in sample]) if sample else np.zeros((0, 3)),
        ref_e, ref_f, [m.n_atoms for m in mols])
    numbers["lost"] = lost + sum(d[3] is None for d in done)
    e2e = {"setup_s": setup_s,
           "serve_graphs_per_s": len(served) / ctx.seconds,
           "serve_latency_p99_ms": float(np.percentile(lat_ms, 99)) if lat_ms else FAILED_MS}
    return {"e2e": e2e, "record": record, "numbers": numbers, "peak_bytes": peak,
            "attempted": len(window), "failed": len(window) - len(served)}



def reference_answers(params, rcfg, mols, traffic, dev):
    """The reference's energies [n] and concatenated forces [atoms, 3] of
    ``mols``, in blocks of graphs."""
    ref_e, ref_f = [], [np.zeros((0, 3))]
    with torch.enable_grad():
        for block in mace.blocks_of(mols, traffic["reference_block_atoms"]):
            g = mace.batch_of(block, dev.device)
            e, f = mace.energy_forces(params, rcfg, g, len(block), False)
            ref_e += e.detach().cpu().tolist()
            ref_f.append(f.detach().cpu().numpy())
    return ref_e, np.concatenate(ref_f)
