"""Cost-model-driven kernel autotuner: pick impl + tile sizes per shape.

Port of the JAX package's ``kernels/autotune.py``.  The registry makes
every strategy *selectable*; this module makes the selection *automatic*,
from three sources:

1. **Measured trajectory** (``bench_kernels.json`` beside this file,
   written by ``kernels/bench.py``): fwd / fwd+bwd timings per
   ``(kind, impl, shape)``.  When a row exists for a matching, or
   near-matching, shape bucket, measurement wins.
2. **Analytic roofline model** (``roofline.analytic.kernel_cell_cost``):
   FLOP/byte cells per ``(kind, impl, shape)`` against per-platform peak
   rates (the ``gpu`` peaks are the H100's, ``roofline.analysis.HW``).
   Ranks candidates for shapes nobody has measured yet.
3. **Bounded on-device search** (``tune(shapes, budget_s)``): times the
   candidate matrix through the ``kernels.bench`` harness (on the card,
   CUDA-event times of a CUDA graph's replays) until the budget runs out, appending rows to the trajectory,
   so that the next ``build_table`` decides from measurement.

Decisions are cached in a committed tuning table (``tuning_table.json``
beside this file) that ``Trainer``, ``make_engine``, ``ServeEngine`` and
``GraphServer`` consult at build time whenever a config carries the
``"auto"`` sentinel (``MaceConfig.impl`` / ``interaction_impl``,
``TrainerConfig.impl`` / ``interaction_impl``, ``--impl`` /
``--interaction-impl`` in the entry points).  A shape with no table entry
falls back to the roofline ranking; nothing is measured at build time.

Tuning-table schema (``schema`` = 1), the JAX one under the port's names::

    {"schema": 1, "generated_by": "repro_torch.kernels.autotune",
     "entries": [
       {"kind": "interaction", "platform": "gpu", "mode": "fwd_bwd",
        "bucket": "E4096-N512-k32", "dims": {"E": 4096, "N": 512, "k": 32},
        "impl": "cuda", "block_n": 32, "block_e": 128,
        "bwd_impl": "cuda", "precision": "fp32",
        "source": "measured", "score_us": 812.4}]}

Names (``bridge.JAX_IMPL_NAMES``): the JAX ``pallas`` is ``cuda``, its
backward choices ``pallas`` / ``xla`` are ``cuda`` / ``fused``, and the
JAX ``tpu`` platform is the port's ``gpu``.  A ``cuda`` impl on the CPU
runs its plain versions (the registry's ``interpret_only_on``), so it is
never a candidate there at fp32.

Decisions are keyed by **precision** ("fp32" | "bf16" | "fp8"): a
reduced-precision row never answers a fp32 query and vice versa.
``build_table`` emits fp32 + bf16 entries (``TABLE_PRECISIONS``); fp8
resolves by the roofline on the fly.

Shape bucketing: every dim (N/E/k) is rounded up to the next power of two;
a query matches the entry (or row) with the smallest bucket distance
``max_dim |log2(a/b)|``, up to ``NEAR_MATCH_MAX_DIST``.  ``nu`` must match
exactly for ``symcon``.  Ties within ``TIE_RTOL`` break deterministically:
preference ``fused > cuda > ref``, then name, then default-first tiles.

The ``fwd_bwd`` evidence is a forward plus the first-order backward (what
serving's forces cost); a training step differentiates the forces again,
which no trajectory row times.

Regenerating on a machine with the card, and checking anywhere::

    python -m repro_torch.kernels.autotune --tune 60 --write --platform gpu
    PYTHONPATH=src python -m repro_torch.kernels.autotune --check --platform gpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import registry
from repro_torch.roofline.analysis import HW

log = logging.getLogger("repro_torch.autotune")

SCHEMA = 1
AUTO = "auto"
MODES = ("fwd", "fwd_bwd")
KINDS = registry.KINDS

_HERE = Path(__file__).resolve().parent
DEFAULT_TABLE_PATH = Path(
    os.environ.get("REPRO_TORCH_TUNING_TABLE", _HERE / "tuning_table.json")
)
DEFAULT_TRAJECTORY_PATH = Path(
    os.environ.get("REPRO_TORCH_BENCH_KERNELS", _HERE / "bench_kernels.json")
)

# measured scores within this relative band are "tied" and fall through to
# the deterministic preference order below
TIE_RTOL = 0.02
PREFERENCE = ("fused", "cuda", "ref")
# max per-dim |log2 ratio| between query bucket and row/entry bucket
NEAR_MATCH_MAX_DIST = 2.0
# check-mode staleness: a committed decision whose measured score is worse
# than STALE_FACTOR x the current best measured candidate fails --check
STALE_FACTOR = 2.0

# (peak FLOP/s, peak HBM bytes/s) per platform, used ONLY to *rank*
# candidates (roofline time = max(compute, memory) term).  The cpu pair is
# the JAX package's coarse one; the gpu pair is the H100's fp32 rate
# outside the tensor cores and its HBM rate.
ROOFLINE_PEAKS = {
    "cpu": (5.0e10, 2.0e10),
    "gpu": (HW().peak_flops_fp32, HW().hbm_bw),
}
# modelled penalty for running a cuda impl's backward through the fused
# formulation's VJP instead of the backward kernel (extra HBM traffic for
# the re-materialized adjoint): bwd_impl="cuda" wins the roofline ranking
# until someone measures otherwise
XLA_BWD_BYTE_PENALTY = 1.3


def default_platform() -> str:
    """The platform key of this process: ``gpu`` with a CUDA card, else
    ``cpu``."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def platform_of(device) -> str:
    """The platform key of a torch device: ``gpu`` for CUDA, else ``cpu``."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


# ---------------------------------------------------------------------------
# decisions + shape buckets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decision:
    """One autotuner verdict for (kind, shape bucket, platform, mode)."""

    kind: str
    impl: str
    platform: str
    mode: str
    bucket: str
    source: str                       # "measured" | "roofline"
    score_us: Optional[float] = None
    block_n: Optional[int] = None     # set iff the impl consumes blocking
    block_e: Optional[int] = None
    bwd_impl: Optional[str] = None    # set iff the impl has a custom bwd
    # compute precision this decision was scored at; fp32 rows and
    # reduced-precision rows never answer each other's queries
    precision: str = "fp32"

    def describe(self) -> str:
        bits = [f"{self.kind}[{self.bucket},{self.platform},{self.mode}]",
                f"-> {self.impl}"]
        if self.precision != "fp32":
            bits.append(f"@{self.precision}")
        if self.block_n is not None:
            bits.append(f"block {self.block_n}x{self.block_e}")
        if self.bwd_impl is not None:
            bits.append(f"bwd={self.bwd_impl}")
        score = f"{self.score_us:.1f}us" if self.score_us else "unscored"
        bits.append(f"({self.source}, {score})")
        return " ".join(bits)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, int(x)))))


_KIND_DIMS = {
    "symcon": ("N", "k"),
    "channelwise_tp": ("E", "k"),
    "interaction": ("E", "N", "k"),
}


def bucket_dims(kind: str, params: Dict[str, Any]) -> Dict[str, int]:
    """Pow2-rounded shape bucket for a trajectory row / query shape."""
    kind = registry.canonical_kind(kind)
    dims = {d: _pow2ceil(params[d]) for d in _KIND_DIMS[kind] if d in params}
    if kind == "symcon" and "nu" in params:
        dims["nu"] = int(params["nu"])  # exact: tables differ structurally
    return dims


def bucket_key(kind: str, params: Dict[str, Any]) -> str:
    dims = bucket_dims(kind, params)
    return "-".join(f"{d}{dims[d]}" for d in sorted(dims))


def bucket_distance(a: Dict[str, int], b: Dict[str, int]) -> float:
    """max per-dim |log2 ratio|; inf on dim-set mismatch or nu mismatch."""
    if set(a) != set(b):
        return math.inf
    dist = 0.0
    for d in a:
        if d == "nu":
            if a[d] != b[d]:
                return math.inf
            continue
        dist = max(dist, abs(math.log2(a[d] / b[d])))
    return dist


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def viable_candidates(
    kind: str, platform: str, mode: str, precision: str = "fp32"
) -> List[str]:
    """Registry-pruned candidate impls at ``precision``: running their own
    code on ``platform`` (a cuda impl on the CPU runs its plain versions:
    correct, never a performance candidate) and, for ``fwd_bwd``,
    differentiable there.

    Reduced precisions relax that: asking for bf16/fp8 is an explicit
    accuracy trade, so the precision-matching cuda variants stay selectable
    on the CPU rather than the query failing outright; an impl of the
    *wrong* precision is never a candidate."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    out = []
    for name in registry.available(
        kind, platform=platform, compiled_only=(precision == "fp32"),
        precision=precision,
    ):
        impl = registry.get_impl(kind, name)
        if mode == "fwd_bwd" and impl.uses_kernel and not impl.has_custom_bwd:
            continue
        out.append(name)
    return out


def _base_impl(name: str) -> str:
    """Strip a ``_bf16``/``_fp8`` variant suffix: precision variants share
    the base impl's cost cells and preference rank."""
    for prec in ("bf16", "fp8"):
        if name.endswith("_" + prec):
            return name[: -len(prec) - 1]
    return name


def _pref_index(name: str) -> int:
    try:
        return PREFERENCE.index(_base_impl(name))
    except ValueError:
        return len(PREFERENCE)


def _block_candidates_for(
    kind: str,
    name: str,
    params: Dict[str, Any],
    block_candidates: Optional[Sequence[Tuple[int, int]]],
) -> List[Tuple[Optional[int], Optional[int]]]:
    """Tile geometries of a blocking-consuming impl: the caller's, else
    ``block_size_candidates`` without those the forward kernel refuses (it
    sorts at most ``MAX_EPB`` slots a tile)."""
    impl = registry.get_impl(kind, name)
    if not impl.consumes_blocking:
        return [(None, None)]
    if block_candidates:
        return [tuple(c) for c in block_candidates]
    from repro_torch.data.blocking import block_size_candidates
    from repro_torch.kernels.channelwise_tp.kernel import MAX_EPB

    cands = block_size_candidates(int(params["N"]), int(params["E"]))
    return [c for c in cands if c[1] <= MAX_EPB] or [(cands[0][0], MAX_EPB)]


def _bwd_candidates_for(kind: str, name: str, mode: str) -> List[Optional[str]]:
    impl = registry.get_impl(kind, name)
    if mode != "fwd_bwd" or not impl.has_custom_bwd:
        return [None]
    return ["cuda", "fused"]


# ---------------------------------------------------------------------------
# measured-trajectory scoring
# ---------------------------------------------------------------------------


def load_trajectory(path: Optional[Path] = None) -> List[Dict]:
    """Runs list from the bench trajectory; a missing / corrupt / stale-
    schema file yields ``[]`` (the roofline fallback takes over)."""
    path = Path(path) if path is not None else DEFAULT_TRAJECTORY_PATH
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    if not isinstance(payload, dict) or payload.get("schema") != SCHEMA:
        return []
    runs = payload.get("runs", [])
    return runs if isinstance(runs, list) else []


def _row_config_key(kind: str, row: Dict) -> Tuple:
    """(impl, block_n, block_e, bwd_impl, precision) identity for a
    trajectory row: a ``blocked`` row without explicit tile sizes ran the
    defaults; a cuda-family row without an explicit ``bwd_impl`` ran the
    backward kernel; a row without a ``precision`` ran at the impl's
    registered precision."""
    p = row.get("params", {})
    impl = row.get("impl")
    bn = be = None
    try:
        reg = registry.get_impl(kind, impl)
    except KeyError:
        reg = None
    if reg is not None and reg.consumes_blocking and p.get("blocked"):
        from repro_torch.data.blocking import DEFAULT_BLOCK_E, DEFAULT_BLOCK_N

        bn = int(p.get("block_n") or DEFAULT_BLOCK_N)
        be = int(p.get("block_e") or DEFAULT_BLOCK_E)
    bwd = None
    if reg is not None and reg.has_custom_bwd and row.get("mode") == "fwd_bwd":
        bwd = p.get("bwd_impl", "cuda")
    prec = p.get("precision") or (reg.precision if reg is not None else "fp32")
    return (impl, bn, be, bwd, prec)


def measured_scores(
    runs: Sequence[Dict],
    kind: str,
    platform: str,
    mode: str,
    params: Dict[str, Any],
    *,
    max_dist: float = NEAR_MATCH_MAX_DIST,
) -> Dict[Tuple, Tuple[float, float]]:
    """Newest measured ``{(impl, block_n, block_e, bwd_impl, precision):
    (us, dist)}`` per candidate config on ``platform``, nearest shape
    bucket winning (newest row wins ties at equal distance).  A row without
    a positive ``us`` (a candidate that ran out of memory) is no
    evidence."""
    kind = registry.canonical_kind(kind)
    query = bucket_dims(kind, params)
    best: Dict[Tuple, Tuple[float, float]] = {}
    for run in reversed(runs):  # newest first
        if run.get("backend") != platform:
            continue
        for row in run.get("rows", []):
            if row.get("kind") != kind or row.get("mode") != mode:
                continue
            us = row.get("us")
            if not isinstance(us, (int, float)) or us <= 0:
                continue
            dist = bucket_distance(query, bucket_dims(kind, row.get("params", {})))
            if dist > max_dist:
                continue
            key = _row_config_key(kind, row)
            if key not in best or dist < best[key][1]:
                best[key] = (float(us), dist)
    return best


# ---------------------------------------------------------------------------
# roofline fallback scoring
# ---------------------------------------------------------------------------


def roofline_score_us(
    kind: str,
    impl: str,
    params: Dict[str, Any],
    platform: str,
    mode: str,
    *,
    block_n: Optional[int] = None,
    block_e: Optional[int] = None,
    bwd_impl: Optional[str] = None,
    spec: Any = None,
) -> float:
    """Modelled microseconds: max(compute term, memory term) against the
    per-platform peaks: a *ranking* signal, not a prediction."""
    from repro_torch.roofline.analytic import kernel_cell_cost

    shape = dict(params)
    if block_n is not None:
        shape["block_n"], shape["block_e"] = block_n, block_e
    # precision variants share the base impl's cost cells (see _base_impl)
    cell = kernel_cell_cost(kind, _base_impl(impl), shape, mode=mode, spec=spec)
    peak_f, peak_b = ROOFLINE_PEAKS.get(platform, ROOFLINE_PEAKS["cpu"])
    bytes_ = cell["hbm_bytes"]
    if bwd_impl == "fused":
        bytes_ *= XLA_BWD_BYTE_PENALTY
    return max(cell["flops"] / peak_f, bytes_ / peak_b) * 1e6


# ---------------------------------------------------------------------------
# deciding
# ---------------------------------------------------------------------------


def candidate_scores(
    kind: str,
    params: Dict[str, Any],
    platform: str,
    mode: str,
    *,
    runs: Optional[Sequence[Dict]] = None,
    block_candidates: Optional[Sequence[Tuple[int, int]]] = None,
    spec: Any = None,
    precision: str = "fp32",
) -> Tuple[Dict[Tuple, float], str]:
    """Score every pruned candidate config at ``precision``.  Returns
    ``({(impl, bn, be, bwd, precision): us}, source)``: when *any*
    candidate config has a measured row within the near-match distance,
    measurement is authoritative and unmeasured configs are dropped (never
    mix measured and modelled numbers); otherwise every config is
    roofline-scored."""
    kind = registry.canonical_kind(kind)
    names = viable_candidates(kind, platform, mode, precision)
    if not names:
        raise LookupError(
            f"no candidate impls for {kind!r} on {platform!r} "
            f"(mode={mode}, precision={precision}); "
            f"registry: {registry.available(kind)}"
        )
    configs: List[Tuple] = []
    for name in names:
        for bn, be in _block_candidates_for(kind, name, params, block_candidates):
            for bwd in _bwd_candidates_for(kind, name, mode):
                configs.append((name, bn, be, bwd, precision))
    measured = measured_scores(runs or [], kind, platform, mode, params)
    picked = {c: measured[c][0] for c in configs if c in measured}
    if picked:
        return picked, "measured"
    return {
        (name, bn, be, bwd, prec): roofline_score_us(
            kind, name, params, platform, mode,
            block_n=bn, block_e=be, bwd_impl=bwd, spec=spec,
        )
        for (name, bn, be, bwd, prec) in configs
    }, "roofline"


def _pick(scored: Dict[Tuple, float]) -> Tuple[Tuple, float]:
    """Deterministic winner: best score, ties within TIE_RTOL broken by
    impl preference order, then name, then default-first tile geometry."""
    best_us = min(scored.values())
    tied = [c for c, us in scored.items() if us <= best_us * (1.0 + TIE_RTOL)]

    from repro_torch.data.blocking import DEFAULT_BLOCK_E, DEFAULT_BLOCK_N

    def order(cfg):
        name, bn, be, bwd, _prec = cfg
        return (
            _pref_index(name), name,
            (bn, be) != (None, None) and (bn, be) != (DEFAULT_BLOCK_N, DEFAULT_BLOCK_E),
            bn or 0, be or 0, bwd or "",
        )

    winner = sorted(tied, key=order)[0]
    return winner, scored[winner]


def decide(
    kind: str,
    params: Dict[str, Any],
    platform: str,
    mode: str,
    *,
    runs: Optional[Sequence[Dict]] = None,
    block_candidates: Optional[Sequence[Tuple[int, int]]] = None,
    spec: Any = None,
    precision: str = "fp32",
) -> Decision:
    """Full decision for one (kind, shape, platform, mode, precision):
    measured rows when any exist in-bucket, the roofline ranking
    otherwise."""
    scored, source = candidate_scores(
        kind, params, platform, mode,
        runs=runs, block_candidates=block_candidates, spec=spec,
        precision=precision,
    )
    (name, bn, be, bwd, prec), us = _pick(scored)
    return Decision(
        kind=registry.canonical_kind(kind), impl=name, platform=platform,
        mode=mode, bucket=bucket_key(kind, params), source=source,
        score_us=float(us), block_n=bn, block_e=be, bwd_impl=bwd,
        precision=prec,
    )


# ---------------------------------------------------------------------------
# the committed tuning table
# ---------------------------------------------------------------------------

# precisions the committed table covers per bucket; fp8 stays off-table
# (roofline-resolved on the fly, as in the JAX package)
TABLE_PRECISIONS = ("fp32", "bf16")

# canonical shapes every table covers even with an empty trajectory: the
# JAX package's (bench_kernels quick + full tiers and the trainer-default
# bin) and the main paths' at the paper's width (128 channels,
# edge_factor 48): the serving buckets of 64 and 256 atoms and the
# 3,072-atom training bin
CANONICAL_SHAPES: Dict[str, List[Dict[str, int]]] = {
    "symcon": [
        {"N": 64, "k": 8, "nu": 2},
        {"N": 512, "k": 32, "nu": 2},
        {"N": 64, "k": 128, "nu": 2},
        {"N": 256, "k": 128, "nu": 2},
        {"N": 3072, "k": 128, "nu": 2},
    ],
    "channelwise_tp": [
        {"E": 256, "k": 8},
        {"E": 2048, "k": 32},
        {"E": 3072, "k": 128},
        {"E": 12288, "k": 128},
        {"E": 147456, "k": 128},
    ],
    "interaction": [
        {"E": 256, "N": 64, "k": 8},
        {"E": 4096, "N": 512, "k": 32},
        {"E": 24576, "N": 512, "k": 32},   # capacity 512 x edge_factor 48
        {"E": 3072, "N": 64, "k": 128},
        {"E": 12288, "N": 256, "k": 128},
        {"E": 147456, "N": 3072, "k": 128},
    ],
}


def _observed_shapes(runs: Sequence[Dict], kind: str) -> List[Dict[str, int]]:
    seen: Dict[str, Dict[str, int]] = {}
    for run in runs:
        for row in run.get("rows", []):
            if row.get("kind") != kind:
                continue
            p = row.get("params", {})
            dims = {d: int(p[d]) for d in _KIND_DIMS[kind] if d in p}
            if kind == "symcon" and "nu" in p:
                dims["nu"] = int(p["nu"])
            if len(dims) < len(_KIND_DIMS[kind]):
                continue
            seen.setdefault(bucket_key(kind, dims), dims)
    return list(seen.values())


def entry_from_decision(d: Decision, dims: Dict[str, int]) -> Dict[str, Any]:
    return {
        "kind": d.kind, "platform": d.platform, "mode": d.mode,
        "bucket": d.bucket, "dims": {k: int(v) for k, v in dims.items()},
        "impl": d.impl, "block_n": d.block_n, "block_e": d.block_e,
        "bwd_impl": d.bwd_impl, "precision": d.precision, "source": d.source,
        "score_us": round(d.score_us, 2) if d.score_us is not None else None,
    }


def build_table(
    *,
    platforms: Optional[Sequence[str]] = None,
    trajectory_path: Optional[Path] = None,
    extra_shapes: Optional[Dict[str, List[Dict[str, int]]]] = None,
) -> Dict[str, Any]:
    """Recompute every table entry from the current trajectory + roofline.

    ``platforms`` defaults to every backend observed in the trajectory plus
    ``cpu`` and ``gpu``."""
    runs = load_trajectory(trajectory_path)
    if platforms is None:
        seen = {r.get("backend") for r in runs if r.get("backend")}
        platforms = sorted(seen | {"cpu", "gpu"})
    entries = []
    for platform in platforms:
        for kind in KINDS:
            shapes: Dict[str, Dict[str, int]] = {}
            for dims in CANONICAL_SHAPES[kind] + _observed_shapes(runs, kind) \
                    + (extra_shapes or {}).get(kind, []):
                shapes.setdefault(bucket_key(kind, dims), dict(dims))
            for bkey in sorted(shapes):
                dims = shapes[bkey]
                for mode in MODES:
                    for precision in TABLE_PRECISIONS:
                        try:
                            d = decide(kind, dims, platform, mode, runs=runs,
                                       precision=precision)
                        except LookupError:
                            if precision == "fp32":
                                raise
                            continue  # no variant at this precision here
                        entries.append(entry_from_decision(d, bucket_dims(kind, dims)))
    entries.sort(key=lambda e: (e["platform"], e["kind"], e["mode"],
                                e.get("precision", "fp32"), e["bucket"]))
    return {
        "schema": SCHEMA,
        "generated_by": "repro_torch.kernels.autotune",
        "entries": entries,
    }


def write_table(payload: Dict[str, Any], path: Optional[Path] = None) -> Path:
    path = Path(path) if path is not None else DEFAULT_TABLE_PATH
    path.write_text(json.dumps(payload, indent=1, sort_keys=False) + "\n")
    return path


_TABLE_CACHE: Dict[Tuple[str, float], Optional[Dict]] = {}


def load_table(path: Optional[Path] = None) -> Optional[Dict[str, Any]]:
    """Schema-checked table payload, or None when absent/invalid.  Cached
    per (path, mtime) so per-engine-build consultation stays free."""
    path = Path(path) if path is not None else DEFAULT_TABLE_PATH
    try:
        mtime = path.stat().st_mtime
    except OSError:
        return None
    key = (str(path), mtime)
    if key not in _TABLE_CACHE:
        try:
            payload = json.loads(path.read_text())
        except (OSError, ValueError):
            payload = None
        if not isinstance(payload, dict) or payload.get("schema") != SCHEMA \
                or not isinstance(payload.get("entries"), list):
            payload = None
        _TABLE_CACHE[key] = payload
    return _TABLE_CACHE[key]


def lookup(
    table: Dict[str, Any],
    kind: str,
    params: Dict[str, Any],
    platform: str,
    mode: str,
    *,
    precision: str = "fp32",
    max_dist: float = NEAR_MATCH_MAX_DIST,
) -> Optional[Decision]:
    """Nearest-bucket table entry as a Decision (None when nothing lies
    within the near-match distance, or the entry's impl is no longer a
    viable registry candidate).  Only entries of the queried ``precision``
    take part; an entry without a ``precision`` field is fp32."""
    kind = registry.canonical_kind(kind)
    query = bucket_dims(kind, params)
    best = None
    for e in table.get("entries", []):
        if (e.get("kind"), e.get("platform"), e.get("mode")) != (kind, platform, mode):
            continue
        if e.get("precision", "fp32") != precision:
            continue
        dist = bucket_distance(query, e.get("dims", {}))
        if dist > max_dist:
            continue
        rank = (dist, e.get("bucket", ""))
        if best is None or rank < best[0]:
            best = (rank, e)
    if best is None:
        return None
    e = best[1]
    if e.get("impl") not in viable_candidates(kind, platform, mode, precision):
        return None
    return Decision(
        kind=kind, impl=e["impl"], platform=platform, mode=mode,
        bucket=e.get("bucket", bucket_key(kind, params)),
        source=e.get("source", "measured"), score_us=e.get("score_us"),
        block_n=e.get("block_n"), block_e=e.get("block_e"),
        bwd_impl=e.get("bwd_impl"), precision=precision,
    )


def check_table(
    platform: str,
    *,
    table_path: Optional[Path] = None,
    trajectory_path: Optional[Path] = None,
) -> List[str]:
    """Check mode: problems list (empty = healthy) for ``platform``.

    Fails on: missing/corrupt/wrong-schema table, malformed entries,
    missing fwd_bwd coverage for a kernel kind on the platform, entries
    naming impls that are no longer viable candidates, and *staleness*: a
    committed decision whose own measured score in the trajectory is worse
    than ``STALE_FACTOR`` x the best measured candidate of its bucket
    (timing noise between close candidates does not fail the check)."""
    path = Path(table_path) if table_path is not None else DEFAULT_TABLE_PATH
    if not path.exists():
        return [f"tuning table missing: {path}"]
    table = load_table(path)
    if table is None:
        return [f"tuning table unreadable or schema != {SCHEMA}: {path}"]
    problems = []
    covered = set()
    runs = load_trajectory(trajectory_path)
    for i, e in enumerate(table["entries"]):
        missing = [f for f in ("kind", "platform", "mode", "bucket", "dims",
                               "impl", "source") if f not in e]
        if missing:
            problems.append(f"entry {i} missing fields {missing}")
            continue
        if e["kind"] not in KINDS or e["mode"] not in MODES:
            problems.append(f"entry {i} has unknown kind/mode {e['kind']}/{e['mode']}")
            continue
        if e["platform"] != platform:
            continue
        prec = e.get("precision", "fp32")
        if prec == "fp32":
            # coverage is a fp32 guarantee; precision rows are additive
            covered.add((e["kind"], e["mode"]))
        viable = viable_candidates(e["kind"], platform, e["mode"], prec)
        if e["impl"] not in viable:
            problems.append(
                f"{e['kind']}[{e['bucket']},{platform},{e['mode']},{prec}]: "
                f"impl {e['impl']!r} is not a viable candidate (viable: {viable})"
            )
            continue
        scores = measured_scores(runs, e["kind"], platform, e["mode"],
                                 e["dims"], max_dist=0.0)
        # only viable same-precision candidates set the staleness baseline
        scores = {c: v for c, v in scores.items() if c[0] in viable and c[4] == prec}
        if not scores:
            continue
        best = min(us for us, _ in scores.values())
        mine = [us for (impl, *_), (us, _) in scores.items() if impl == e["impl"]]
        if mine and min(mine) > STALE_FACTOR * best:
            problems.append(
                f"{e['kind']}[{e['bucket']},{platform},{e['mode']}]: stale — "
                f"committed impl {e['impl']!r} measures {min(mine):.1f}us vs "
                f"best {best:.1f}us (> {STALE_FACTOR}x)"
            )
    for kind in KINDS:
        if (kind, "fwd_bwd") not in covered:
            problems.append(f"no fwd_bwd entry for kind {kind!r} on platform {platform!r}")
    return problems


# ---------------------------------------------------------------------------
# bounded on-device search
# ---------------------------------------------------------------------------


def tune(
    shapes: Dict[str, List[Dict[str, int]]],
    budget_s: float,
    *,
    platform: Optional[str] = None,
    mode: str = "fwd_bwd",
    repeats: int = 5,
    trajectory_path: Optional[Path] = None,
    quick: bool = False,
    precision: str = "fp32",
) -> List[Dict]:
    """Bounded search: time candidate configs for ``shapes`` through the
    ``kernels.bench`` harness (on the card for ``gpu``: CUDA events, the
    median of ``repeats`` graph replays after a warm-up call) until ``budget_s`` wall
    seconds are spent, append the rows to the trajectory, and return them.

    The candidate matrix is pruned exactly like ``decide``'s and iterated
    shape-major, so an exhausted budget still leaves *complete* candidate
    sets for the shapes it reached.  A candidate that runs out of device
    memory leaves a row with no ``us`` and ``"failed": "out of memory"``
    (the harness catches that error alone), which no decision reads."""
    from repro_torch.kernels.bench import time_impl, write_bench_json

    platform = platform or default_platform()
    device = "cuda" if platform == "gpu" else "cpu"
    grad = mode == "fwd_bwd"
    t0 = time.perf_counter()
    rows: List[Dict] = []
    done = False
    for kind, shape_list in shapes.items():
        if done:
            break
        for params in shape_list:
            configs = []
            for name in viable_candidates(kind, platform, mode, precision):
                for bn, be in _block_candidates_for(kind, name, params, None):
                    configs.append((name, bn, be))
            if time.perf_counter() - t0 > budget_s:
                log.info("tune: budget %.1fs exhausted before %s %s", budget_s, kind, params)
                done = True
                break
            for name, bn, be in configs:
                rows.extend(time_impl(
                    kind, name, grad=grad, repeats=repeats,
                    block_n=bn, block_e=be, device=device, **params,
                ))
    if rows:
        write_bench_json(rows, trajectory_path or DEFAULT_TRAJECTORY_PATH,
                         grad=grad, quick=quick, device=device)
    return rows


# ---------------------------------------------------------------------------
# "auto" resolution for model/trainer configs
# ---------------------------------------------------------------------------


def needs_resolution(mace_cfg) -> bool:
    return AUTO in (mace_cfg.impl, mace_cfg.interaction_impl)


def _decision_for(
    kind: str,
    params: Dict[str, Any],
    platform: str,
    mode: str,
    table: Optional[Dict],
    block_candidates,
    precision: str = "fp32",
) -> Decision:
    if table is not None:
        d = lookup(table, kind, params, platform, mode, precision=precision)
        if d is not None and (d.block_n is None or not block_candidates
                              or (d.block_n, d.block_e) in map(tuple, block_candidates)):
            return d
        if d is not None:
            # a caller whose collation is fixed (``block_candidates``) cannot
            # take the entry's other tiles (the JAX package takes them
            # regardless, which would break that collation): the
            # trajectory's rows at the caller's tiles decide, measurement
            # winning over the roofline as in the table
            return decide(kind, params, platform, mode, runs=load_trajectory(),
                          block_candidates=block_candidates, precision=precision)
    # no table / no matching entry: rank with the roofline model on the
    # fly (never measure at build time: that is tune()'s job)
    return decide(kind, params, platform, mode, runs=[],
                  block_candidates=block_candidates, precision=precision)


def resolve_mace_config(
    mace_cfg,
    *,
    capacity: int,
    edge_factor: int,
    platform: Optional[str] = None,
    mode: str = "fwd_bwd",
    table: Optional[Dict[str, Any]] = None,
    table_path: Optional[Path] = None,
    block_candidates: Optional[Sequence[Tuple[int, int]]] = None,
) -> Tuple[Any, Dict[str, Decision]]:
    """Replace ``"auto"`` impl sentinels in a :class:`MaceConfig` with the
    tuning table's decisions for the run's shape bucket.

    * ``impl="auto"`` resolves the contraction impl shared by ``symcon``
      and ``channelwise_tp`` (one config field feeds both kinds: when the
      per-kind winners disagree, the summed score decides, then the
      preference order).
    * ``interaction_impl="auto"`` resolves the interaction impl *plus* its
      tile geometry (``interaction_block_n`` is updated; callers owning a
      BinShape must adopt the decision's ``block_n``/``block_e``, as the
      Trainer and GraphServer do) and its ``bwd_impl``.

    ``platform`` defaults to :func:`default_platform`; callers with a
    device pass :func:`platform_of` it.  Returns ``(resolved_cfg, {kind:
    Decision})``; a config with no ``"auto"`` sentinel is returned
    unchanged with no decisions."""
    if not needs_resolution(mace_cfg):
        return mace_cfg, {}
    platform = platform or default_platform()
    if table is None:
        table = load_table(table_path)
    N = int(capacity)
    E = int(capacity) * int(edge_factor)
    k = int(mace_cfg.channels)
    # the config's precision keys every lookup: a bf16 build only sees bf16
    # rows/candidates (and the resolved names carry the suffix)
    precision = getattr(mace_cfg, "precision", "fp32")
    decisions: Dict[str, Decision] = {}

    if mace_cfg.impl == AUTO:
        sc_params = {"N": N, "k": k, "nu": int(mace_cfg.correlation)}
        tp_params = {"E": E, "k": k}
        d_sc = _decision_for("symcon", sc_params, platform, mode, table, None, precision)
        d_tp = _decision_for("channelwise_tp", tp_params, platform, mode, table, None,
                             precision)
        if d_sc.impl == d_tp.impl:
            name = d_sc.impl
        else:
            totals: Dict[str, float] = {}
            for d in (d_sc, d_tp):
                totals[d.impl] = totals.get(d.impl, 0.0) + (d.score_us or 0.0)
            name = sorted(totals, key=lambda n: (totals[n], _pref_index(n), n))[0]
            # re-bind both kinds to the shared winner for honest reporting
            d_sc = dataclasses.replace(d_sc, impl=name) if d_sc.impl != name else d_sc
            d_tp = dataclasses.replace(d_tp, impl=name) if d_tp.impl != name else d_tp
        decisions["symcon"], decisions["channelwise_tp"] = d_sc, d_tp
        mace_cfg = dataclasses.replace(mace_cfg, impl=name)

    if mace_cfg.interaction_impl == AUTO:
        d = _decision_for(
            "interaction", {"E": E, "N": N, "k": k}, platform, mode, table,
            block_candidates, precision,
        )
        repl: Dict[str, Any] = {"interaction_impl": d.impl}
        if d.block_n is not None:
            repl["interaction_block_n"] = int(d.block_n)
        if d.bwd_impl is not None:
            repl["interaction_bwd_impl"] = d.bwd_impl
        decisions["interaction"] = d
        mace_cfg = dataclasses.replace(mace_cfg, **repl)

    for d in decisions.values():
        log.info("autotune: %s", d.describe())
    return mace_cfg, decisions


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Sequence[str] = ()) -> int:
    ap = argparse.ArgumentParser(
        description="kernel autotuner: build/check the committed tuning "
                    "table, optionally after a bounded on-device search"
    )
    ap.add_argument("--write", action="store_true",
                    help="recompute the table from the trajectory + roofline and write it")
    ap.add_argument("--check", action="store_true",
                    help="check mode: exit 1 when the table is missing, "
                         "schema-invalid, incomplete, or stale for --platform")
    ap.add_argument("--tune", type=float, default=0.0, metavar="BUDGET_S",
                    help="bounded search: time candidate configs for the "
                         "canonical shapes until the budget runs out, "
                         "appending rows to the trajectory first")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="platform key (default: gpu with a CUDA card, else cpu)")
    ap.add_argument("--table", default=None, help="tuning-table path")
    ap.add_argument("--trajectory", default=None, help="bench_kernels.json path")
    ap.add_argument("--quick", action="store_true",
                    help="mark tune() trajectory rows as quick-tier")
    args = ap.parse_args(list(argv))

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    platform = args.platform or default_platform()
    table_path = Path(args.table) if args.table else DEFAULT_TABLE_PATH
    traj_path = Path(args.trajectory) if args.trajectory else DEFAULT_TRAJECTORY_PATH

    if args.tune > 0:
        rows = tune(CANONICAL_SHAPES, args.tune, platform=platform,
                    trajectory_path=traj_path, quick=args.quick)
        print(f"tune: appended {len(rows)} rows to {traj_path}")
    if args.write:
        payload = build_table(trajectory_path=traj_path)
        path = write_table(payload, table_path)
        n_meas = sum(e["source"] == "measured" for e in payload["entries"])
        print(f"wrote {len(payload['entries'])} entries ({n_meas} measured) to {path}")
    if args.check:
        problems = check_table(platform, table_path=table_path, trajectory_path=traj_path)
        if problems:
            for p in problems:
                print(f"STALE/INVALID: {p}")
            return 1
        print(f"tuning table OK for platform {platform!r} ({table_path})")
    if not (args.write or args.check or args.tune > 0):
        ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
