"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository, on a machine with the
CUDA cards the cell asks for: without them it exits with code 2 and prints
no result.  The last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks``: every number that decided ``correct`` beside its limit, which
also end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, Optional  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a mix is given for one run."""

    seed: int
    seconds: float
    trace: bool
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    dev: harness.Device
    t_start: float
    # a test's or a control run's hook on the program object the mix
    # builds (the trainer, the server): it may break the timed path
    fault: Optional[Callable[[Any], None]] = None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: Optional[Any] = None, overrides: Optional[Dict] = None,
         fault: Optional[Callable[[Any], None]] = None) -> int:
    """One run.  ``device``, ``overrides`` ({"config": ..., "traffic": ...,
    "limits": ...} dict updates) and ``fault`` are for the CPU tests, which
    drive a run at a small size without the card."""
    args = parse(argv)
    harness.prepare_environment()
    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    if device is None:
        try:
            device = harness.require_cards(cell["chips"])
        except harness.NoCard as exc:
            print(f"perfbench: {exc}", file=sys.stderr)
            return 2
    over = overrides or {}
    config = {**harness.data_file("configs", cell["config"]), **over.get("config", {})}
    traffic = {**harness.data_file("traffic", cell["traffic"]), **over.get("traffic", {})}
    limits = {**harness.limits_of(cell["name"]), **over.get("limits", {})}
    dev = harness.Device(device)
    ctx = Context(args.seed, args.seconds, bool(args.trace), config, traffic, dev, T_START,
                  fault)
    out = harness.module("mixes", traffic["mix"]).run(ctx)

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    metrics: Dict[str, Any] = {}
    for m in harness.metrics_of(bench, cell["name"], bool(args.trace)):
        if args.trace:
            value = harness.module("metrics", m["name"]).read(out["record"])
        else:
            value = out["e2e"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = dict(dev.describe(cell["chips"]), memory_peak_bytes=out["peak_bytes"])
    breakdown = None
    prof = out["record"].get("profile")
    if args.trace and prof is not None:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    correct, checks = harness.judge(out["numbers"], limits)
    if dev.cuda:
        print(f"card: {harness.card_line()}", file=sys.stderr)
    print(harness.checks_text(checks), file=sys.stderr, flush=True)
    print(harness.result_line(correct, out["attempted"], out["failed"], metrics,
                              device_info, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
