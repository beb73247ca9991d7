"""Kernel timing harness: each (kind, impl) forward, and forward plus
first-order backward, per shape, into the autotuner's trajectory.

Port of the JAX package's ``benchmarks/bench_kernels.py`` timing matrix
(``time_impl``, ``bench_matrix``, the trajectory file and its retention).
Its command line is ``repro_torch.launch.bench_kernels``; the autotuner's
bounded search (``kernels.autotune.tune``) calls :func:`time_impl` and
:func:`write_bench_json` directly.

On the card each config is timed by CUDA events, the median of
``repeats`` replays of a CUDA graph captured after one warm-up call (the
warm-up builds the kernel library of the config's spec and precision with
``nvcc`` on its first use, so no build lands in a timed call): device
time, as the JAX harness times a compiled function; on the CPU by
``time.perf_counter`` around each call.
Inputs are drawn with numpy from a fixed seed.  ``fwd`` rows time the
forward under ``torch.no_grad``; ``fwd_bwd`` rows time the forward plus
``torch.autograd.grad`` of a scalar loss: the first-order backward, which
is what serving's forces cost, not the training step's grad-of-grad.  A
cuda interaction impl times its backward kernel (``bwd_impl="cuda"``) and
the fused formulation's VJP (``"fused"``) as two ``fwd_bwd`` rows.

A config that runs out of device memory gives a row with ``us`` null and
``"failed": "out of memory"`` after the cache is freed; no other error is
caught, nor an out-of-memory error while a shape's inputs are made (the
shape does not fit at all; at 147,456 edges they take about 0.8 GiB).
Every run appends one record to a trajectory file with ``backend``
``"gpu"`` or ``"cpu"`` and, on the card, ``card``: its name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them.  Not ported: the JAX CLI's CSV sweep of the ref-vs-fused
speedup (``bench_symcon``/``bench_tp``/``bench_interaction``, nu = 3
tables and a jaxpr shape census).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import resolve_device
from repro_torch.core.channelwise_tp import TPSpec
from repro_torch.core.interaction import InteractionSpec
from repro_torch.core.irreps import lspec, sh_spec
from repro_torch.core.symmetric_contraction import SymConSpec, init_symcon_weights
from repro_torch.data.blocking import block_edges, blocking_to_batch
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.registry import capabilities, resolve

OOM = "out of memory"


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _median_seconds(fn: Callable[[], object], repeats: int,
                    device: torch.device) -> Optional[float]:
    """Median seconds per ``fn()`` over ``repeats`` calls after one warm-up
    call, or None when a call ran out of device memory.  On the card the
    call is captured once in a CUDA graph after the warm-up, and each
    repeat is one replay timed by CUDA events: the device time of the
    call's work, as a compiled JAX function is timed, without the host's
    dispatch of each op (which a served bin's graph replay does not pay
    either, and whose noise would otherwise rank the tile geometries)."""
    graph = None
    try:
        fn()
        ts = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()  # the warm-up's blocks, for the graph's pool
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
            with cuda_lib.recording_launches(stream) as tally:
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    fn()

            def replay():
                graph.replay()
                cuda_lib.count_replay(tally)

            replay()
            for _ in range(repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                replay()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
    except torch.cuda.OutOfMemoryError:
        ts = None
    if device.type == "cuda":
        # outside the handler: the traceback's frames, and the tensors they
        # hold, are gone before the graph's pool and the cache are freed
        del graph
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    if ts is None:
        return None
    return float(np.median(ts))


def _forward(fn: Callable[[], torch.Tensor]) -> Callable[[], torch.Tensor]:
    def run():
        with torch.no_grad():
            return fn()
    return run


def _value_and_grad(fn: Callable[[], torch.Tensor], inputs) -> Callable[[], object]:
    """The forward and ``autograd.grad`` of ``sum(fn() ** 2)`` with respect
    to ``inputs``."""
    def run():
        return torch.autograd.grad(torch.sum(fn() ** 2), inputs)
    return run


def _time_pair(fwd, vg, repeats, device):
    """(fwd seconds, fwd+bwd seconds or None); None also for a call that
    ran out of device memory."""
    t_fwd = _median_seconds(fwd, repeats, device)
    t_both = _median_seconds(vg, repeats, device) if vg is not None else None
    return t_fwd, t_both


def _row(kind, impl, mode, params, t):
    if t is None:
        return {"kind": kind, "impl": impl, "mode": mode, "seconds": None,
                "us": None, "params": params, "failed": OOM}
    return {"kind": kind, "impl": impl, "mode": mode, "seconds": t,
            "us": t * 1e6, "params": params}


def _rows_for(kind, impl, params, t_fwd, t_both, *, grad=True):
    """The fwd row and, with ``grad``, the fwd_bwd row of one config; a
    timing of None (out of memory) gives a failed row."""
    rows = [_row(kind, impl, "fwd", params, t_fwd)]
    if grad:
        row = _row(kind, impl, "fwd_bwd", params, t_both)
        if t_both is not None:
            row["fwd_bwd_over_fwd"] = t_both / t_fwd if t_fwd else None
        rows.append(row)
    return rows


def _tensor(x, device, requires_grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device).requires_grad_(requires_grad)


def _impl_at(impl: str, precision: Optional[str]) -> str:
    """``impl`` at ``precision``: ``cuda`` becomes ``cuda_<precision>`` for a
    reduced one; any other name must already compute at it."""
    if precision in (None, "fp32") or impl.endswith("_" + precision):
        return impl
    if impl == "cuda":
        return f"cuda_{precision}"
    raise ValueError(f"impl {impl!r} has no {precision!r} variant")


def interaction_inputs(E, N, k, spec: InteractionSpec, device, seed=2):
    """Y, h, R (leaves that take gradients), senders, receivers, edge_mask."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((E, spec.tp.y_spec.dim), dtype=np.float32)
    h = rng.standard_normal((N, k, spec.tp.h_spec.dim), dtype=np.float32)
    R = rng.standard_normal((E, spec.tp.n_paths, k), dtype=np.float32)
    senders = rng.integers(0, N, E).astype(np.int32)
    receivers = rng.integers(0, N, E).astype(np.int32)
    edge_mask = rng.random(E) < 0.95
    return ([_tensor(a, device, True) for a in (Y, h, R)]
            + [_tensor(a, device) for a in (senders, receivers, edge_mask)])


def time_impl(kind, impl, *, grad=False, repeats=5, N=None, E=None, k=None,
              nu=2, block_n=None, block_e=None, precision=None, device=None):
    """Time one (kind, impl) config at an explicit shape on ``device``
    (``None``: the CUDA card); returns trajectory row dicts.  The one
    timing entry point shared by ``bench_matrix`` and the autotuner's
    bounded search (``kernels.autotune.tune``), so every row of the
    trajectory comes from the same harness.

    ``precision`` runs ``cuda`` as its ``cuda_<precision>`` variant (the
    row records the impl's precision either way).  ``block_n``/``block_e``
    select the tile geometry of a blocking-consuming impl (recorded in the
    row; ignored otherwise).  With ``grad``, a cuda interaction impl is
    timed with both backwards (``params["bwd_impl"]`` ``"cuda"`` and
    ``"fused"``)."""
    dev = resolve_device(device)
    impl = _impl_at(impl, precision)
    k = int(k if k is not None else 8)
    caps = capabilities(kind).get(impl, {})
    # every row carries its precision, so that the autotuner keys measured
    # evidence by it (a bf16 row never answers a fp32 query)
    prec = caps.get("precision", "fp32")

    if kind in ("symcon", "symmetric_contraction"):
        N = int(N if N is not None else 64)
        spec = SymConSpec(lspec(0, 1, 2, 3), lspec(0, 1), int(nu))
        rng = np.random.default_rng(0)
        A = _tensor(rng.standard_normal((N, k, spec.in_spec.dim), dtype=np.float32), dev, True)
        species = _tensor(rng.integers(0, 4, N).astype(np.int32), dev)
        W = {name: w.to(dev).requires_grad_(True) for name, w in init_symcon_weights(
            torch.Generator().manual_seed(0), spec, 4, k).items()}
        fn = resolve("symcon", impl, spec)
        call = lambda: fn(A, species, W)  # noqa: E731
        t_fwd, t_both = _time_pair(
            _forward(call), _value_and_grad(call, [A, *W.values()]) if grad else None,
            repeats, dev)
        return _rows_for("symcon", impl, {"N": N, "k": k, "nu": int(nu), "precision": prec},
                         t_fwd, t_both, grad=grad)

    if kind in ("channelwise_tp", "tp"):
        E = int(E if E is not None else 256)
        tspec = TPSpec(sh_spec(3), lspec(0, 1), lspec(0, 1, 2, 3))
        rng = np.random.default_rng(1)
        Y, h, R = (_tensor(rng.standard_normal(s, dtype=np.float32), dev, True) for s in (
            (E, tspec.y_spec.dim), (E, k, tspec.h_spec.dim), (E, tspec.n_paths, k)))
        fn = resolve("channelwise_tp", impl, tspec)
        call = lambda: fn(Y, h, R)  # noqa: E731
        t_fwd, t_both = _time_pair(
            _forward(call), _value_and_grad(call, [Y, h, R]) if grad else None, repeats, dev)
        return _rows_for("channelwise_tp", impl, {"E": E, "k": k, "precision": prec},
                         t_fwd, t_both, grad=grad)

    if kind in ("interaction", "tp_scatter"):
        E = int(E if E is not None else 256)
        N = int(N if N is not None else 64)
        blocked = bool(caps.get("consumes_blocking"))
        bn = int(block_n) if (blocked and block_n) else 32
        be = int(block_e) if (blocked and block_e) else 128
        base_spec = InteractionSpec(
            TPSpec(sh_spec(3), lspec(0, 1), lspec(0, 1, 2, 3)),
            avg_num_neighbors=12.0, block_n=bn,
        )
        Y, h, R, senders, receivers, edge_mask = interaction_inputs(E, N, k, base_spec, dev)
        blocking = None
        params = {"E": E, "N": N, "k": k, "blocked": blocked, "precision": prec}
        if blocked:
            flat = blocking_to_batch(block_edges(
                receivers.cpu().numpy(), edge_mask.cpu().numpy(), N, block_n=bn, block_e=be))
            blocking = {key: _tensor(flat[f"blk_{key}"], dev)
                        for key in ("perm", "valid", "local", "base")}
            params.update(block_n=bn, block_e=be)

        def calls(spec):
            fn = resolve("interaction", impl, spec)
            call = lambda: fn(Y, h, R, senders, receivers, edge_mask,  # noqa: E731
                              blocking=blocking)
            return _forward(call), _value_and_grad(call, [Y, h, R]) if grad else None

        fwd, vg = calls(base_spec)
        t_fwd, t_both = _time_pair(fwd, vg, repeats, dev)
        if not (grad and caps.get("has_custom_bwd")):
            return _rows_for("interaction", impl, params, t_fwd, t_both, grad=grad)
        # custom-bwd impl: one fwd row, one fwd_bwd row per bwd_impl choice
        rows = _rows_for("interaction", impl, params, t_fwd, None, grad=False)
        rows += _rows_for("interaction", impl, {**params, "bwd_impl": base_spec.bwd_impl},
                          t_fwd, t_both)[1:]
        for alt in ("fused",):
            _, vg_alt = calls(dataclasses.replace(base_spec, bwd_impl=alt))
            t_alt = _median_seconds(vg_alt, repeats, dev)
            rows += _rows_for("interaction", impl, {**params, "bwd_impl": alt},
                              t_fwd, t_alt)[1:]
        return rows

    raise KeyError(f"unknown kernel kind {kind!r}")


# quick (CPU tier) and full benchmark shapes per kind: the JAX package's
MATRIX_SIZES = {
    "symcon": {True: {"N": 64, "k": 8, "nu": 2},
               False: {"N": 512, "k": 32, "nu": 2}},
    "channelwise_tp": {True: {"E": 256, "k": 8}, False: {"E": 2048, "k": 32}},
    "interaction": {True: {"E": 256, "N": 64, "k": 8},
                    False: {"E": 4096, "N": 512, "k": 32}},
}


def bench_matrix(grad=False, quick=False, impls=("ref", "fused", "cuda"),
                 repeats=5, device=None):
    """Time every (kind, impl) in fwd mode and, with ``grad``, through the
    first-order backward of a scalar loss.  ``quick`` shrinks the sizes (on
    the CPU the cuda impls then run their plain versions cheaply)."""
    rows = []
    for kind in ("symcon", "channelwise_tp", "interaction"):
        sizes = MATRIX_SIZES[kind][bool(quick)]
        for impl in impls:
            rows += time_impl(kind, impl, grad=grad, repeats=repeats, device=device, **sizes)
    return rows


MAX_TRAJECTORY_RUNS = 50
KEEP_PER_KEY = 8


def _run_key(run):
    """Retention bucket: runs are interchangeable evidence only within the
    same (backend, quick-tier, grad) combination."""
    return (run.get("backend"), bool(run.get("quick")), bool(run.get("grad")))


def prune_runs(runs, *, max_runs=MAX_TRAJECTORY_RUNS, keep_per_key=KEEP_PER_KEY):
    """Bound the trajectory: keep the newest ``keep_per_key`` runs per
    ``(backend, quick, grad)`` key, then the newest ``max_runs`` overall,
    in chronological (oldest-first) order, so that a burst of quick CPU
    runs can never evict the one full-size run on the card."""
    counts: Dict = {}
    kept_rev = []
    for run in reversed(runs):  # newest first
        key = _run_key(run)
        if counts.get(key, 0) >= keep_per_key:
            continue
        counts[key] = counts.get(key, 0) + 1
        kept_rev.append(run)
    return list(reversed(kept_rev[:max_runs]))


def write_bench_json(rows, path, *, grad, quick, device=None,
                     max_runs=MAX_TRAJECTORY_RUNS, keep_per_key=KEEP_PER_KEY):
    """Append this run to the trajectory file ``{"schema": 1, "runs":
    [...]}``, oldest first, bounded by :func:`prune_runs`.  ``device``
    (``None``: the CUDA card) names the backend; on the card the record
    carries the card's name and power limit.  A corrupt or other-schema
    file is replaced."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    run = {
        "unix_time": int(time.time()),
        "backend": "gpu" if on_card else "cpu",
        # the cuda impls ran their plain versions (the CPU)
        "interpret_kernels": not on_card,
        "grad": bool(grad),
        "quick": bool(quick),
    }
    if on_card:
        run["card"] = card_line()
    run["rows"] = rows
    path = Path(path)
    runs = []
    if path.exists():
        try:
            prior = json.loads(path.read_text())
            if prior.get("schema") == 1:
                runs = list(prior.get("runs", []))
        except (ValueError, AttributeError):
            runs = []
    runs = prune_runs(runs + [run], max_runs=max_runs, keep_per_key=keep_per_key)
    payload = {"schema": 1, "generated_by": "repro_torch.launch.bench_kernels", "runs": runs}
    path.write_text(json.dumps(payload, indent=1) + "\n")
    return payload
