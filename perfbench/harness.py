"""What every cell of the benchmark shares: where things are, the card,
the caches, the profiler's reading, and the result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
found by its name:

* ``configs/<config>.json``: the model's fields as the port runs them;
* ``traffic/<traffic>.json``: the mix's parameters, with ``"mix"`` naming
  ``mixes/<mix>.py``, the code that generates and runs it;
* ``metrics/<metric>.py``: a reader, ``read(record) -> float | None``;
* ``limits/<cell>.json``: the limit of each number ``correct`` compares.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the run may never have loaded: JAX and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_environment() -> None:
    """Point every build and kernel cache into the checkout at fixed paths,
    keep libraries from loading JAX, and put the port on the path."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def data_file(kind: str, name: str) -> Dict[str, Any]:
    return load_json(HERE / kind / f"{name}.json")


def module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics this cell reports: its end-to-end ones without tracing,
    its per-layer ones with."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ----------------------------- the card ------------------------------------


class NoCard(RuntimeError):
    pass


def require_cards(n: int):
    """The CUDA device of a run on ``n`` cards; raises without them."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell needs {n}")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class Device:
    """The device a run computes on.  A benchmark run is always on the
    card; the CPU tests drive the same code on the CPU, where there is
    nothing to synchronise or count."""

    device: Any

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        if not self.cuda:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()

    def describe(self, chips: int) -> Dict[str, Any]:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": chips}
        import torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
                "count": chips}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unreadable"


# ----------------------------- the profiler --------------------------------


class Stretch:
    """A profiled stretch of a run: start, stop and what it read.

    Only the device's activity is recorded: recording every host operation
    as well made a training step half as long again and would read as
    idle device time.  ``read()`` gives the device's busy seconds (the
    union of the intervals in which an operation ran on it), the wall
    seconds between start and stop, each of the four CUDA kernels' device
    seconds and launches, the device operations that took most time, and
    the longest idle gaps, each named by the device operation that ended
    it (what the host was late to start)."""

    def __init__(self, dev: Device):
        from torch.profiler import ProfilerActivity, profile

        self.dev = dev
        self.prof = profile(activities=[ProfilerActivity.CUDA if dev.cuda
                                        else ProfilerActivity.CPU])
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.dev.sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.dev.sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self, symbols: Dict[str, str]) -> Dict[str, Any]:
        from torch.autograd import DeviceType

        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in self.prof.events() if e.device_type == DeviceType.CUDA)
        busy, gaps, cur = 0.0, [], None
        for s, t, name in spans:
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                    gaps.append((s - cur[1], name))
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        if cur is not None:
            busy += cur[1] - cur[0]
        by_op: Dict[str, float] = {}
        for s, t, name in spans:
            by_op[name] = by_op.get(name, 0.0) + (t - s) / 1e6
        kernels = {k: (sum((t - s) / 1e6 for s, t, n in spans if sym in n),
                       sum(1 for _, _, n in spans if sym in n))
                   for k, sym in symbols.items()}
        top = sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:10]
        idle = [[f"before {name}", gap / 1e6] for gap, name in sorted(gaps, reverse=True)[:10]]
        return {"busy_s": busy / 1e6, "window_s": self.t1 - self.t0, "kernels": kernels,
                "device_ops": top, "idle_gaps": idle}


# ----------------------------- the result ----------------------------------


def limits_of(cell: str) -> Dict[str, float]:
    return data_file("limits", cell)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and none missing or not a number."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(isinstance(c["value"], (int, float)) and c["value"] == c["value"]
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any],
                device: Dict[str, Any], checks: Dict[str, Any],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def note(text: str) -> None:
    print(f"perfbench: {text}", file=sys.stderr, flush=True)


def note_setup(t_start: float, marks) -> None:
    """The set-up's phases: seconds from the previous mark to each."""
    prev, parts = t_start, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.2f}")
        prev = t
    note("set-up s: " + ", ".join(parts))


def checks_text(checks: Dict[str, Any]) -> str:
    return "\n".join(f"check {k}: {c['value']!r} limit {c['limit']!r}"
                     for k, c in checks.items())
