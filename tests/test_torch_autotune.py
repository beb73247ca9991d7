"""Port parity, the kernel autotuner: ``repro_torch.kernels.autotune``
against ``repro.kernels.autotune`` on the same synthetic trajectories and
tables, the JAX records mapped to the port's names by
``bridge.tuning_record_from_jax`` (``pallas`` -> ``cuda``, bwd ``pallas`` /
``xla`` -> ``cuda`` / ``fused``, the ``tpu`` platform -> ``gpu``).  One
test here per test of ``tests/test_autotune.py`` (its bench-harness tests
are in ``test_torch_bench_kernels.py``), each on the CPU and, where the
kernels matter, on the accelerator platform of each package.

Tolerances: decisions equal exactly (impl, tile geometry, bwd, source,
bucket, precision), ``score_us`` within 1e-9 relative, and
``kernel_cell_cost`` equal exactly.  The port's ``gpu`` roofline peaks are
the H100's and differ from the JAX ``tpu`` ones on purpose, so a parity
test that ranks by the roofline on the accelerator patches the port's
``ROOFLINE_PEAKS["gpu"]`` to the JAX ``tpu`` pair; on the CPU the peaks
are the same.

Plus what only the port has: the committed ``tuning_table.json`` passes
``check_table`` for ``gpu`` and ``cpu`` and measures every main-path
bucket on the H100; ``"auto"`` training on the CPU gives the losses of the
resolved names spelt out, bit for bit; ``GraphServer`` and ``ServeEngine``
resolve ``"auto"`` and serve.
"""
import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

from repro.core.mace import MaceConfig as JMaceConfig
from repro.kernels import autotune as jat
from repro.roofline.analytic import kernel_cell_cost as jax_cell_cost
from repro_torch.bridge import JAX_BWD_IMPL_NAMES, JAX_IMPL_NAMES, JAX_PLATFORMS
from repro_torch.bridge import tuning_record_from_jax as to_port
from repro_torch.core.mace import MaceConfig
from repro_torch.kernels import autotune as at
from repro_torch.roofline.analytic import kernel_cell_cost

from tests.hypothesis_support import given, settings, st

# (JAX platform, port platform): cpu is cpu; the JAX kernels compile on
# the TPU, the port's on the GPU
PLATFORMS = [("cpu", "cpu"), ("tpu", "gpu")]
ACCEL = ("tpu", "gpu")


def _row(kind, impl, mode, us, **params):
    return {"kind": kind, "impl": impl, "mode": mode,
            "seconds": us / 1e6, "us": us, "params": params}


def _run(rows, backend="cpu", quick=True, grad=True):
    return {"unix_time": 1_000, "backend": backend, "interpret_pallas": backend == "cpu",
            "grad": grad, "quick": quick, "rows": rows}


Q_INT = {"E": 256, "N": 64, "k": 8}
Q_SC = {"N": 64, "k": 8, "nu": 2}


def _ported(runs):
    return [to_port(r) for r in runs]


def _key(d, jax_side):
    """A decision's identity under the port's names."""
    impl, platform, bwd = d.impl, d.platform, d.bwd_impl
    if jax_side:
        impl, platform = JAX_IMPL_NAMES[impl], JAX_PLATFORMS[platform]
        bwd = None if bwd is None else JAX_BWD_IMPL_NAMES[bwd]
    return (d.kind, impl, platform, d.mode, d.bucket, d.source, d.block_n,
            d.block_e, bwd, d.precision)


def _same(jd, pd):
    assert _key(jd, True) == _key(pd, False)
    if jd.score_us is None:
        assert pd.score_us is None
    else:
        assert pd.score_us == pytest.approx(jd.score_us, rel=1e-9)


def _same_entries(jtable, ptable):
    want = to_port(jtable)["entries"]
    got = ptable["entries"]
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w, g = dict(w), dict(g)
        ws, gs = w.pop("score_us"), g.pop("score_us")
        assert g == w
        assert (gs is None) == (ws is None)
        if ws is not None:
            assert gs == pytest.approx(ws, rel=1e-9, abs=0.005)


@pytest.fixture
def jax_peaks():
    """The port's gpu roofline peaks set to the JAX tpu pair."""
    with mock.patch.dict(at.ROOFLINE_PEAKS, {"gpu": jat.ROOFLINE_PEAKS["tpu"]}):
        yield


def _both_decide(kind, params, jp, pp, mode="fwd_bwd", runs=(), **kw):
    jd = jat.decide(kind, params, jp, mode, runs=list(runs), **kw)
    pd = at.decide(kind, params, pp, mode, runs=_ported(runs), **kw)
    _same(jd, pd)
    return pd


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,params", [
    ("interaction", {"E": 4096, "N": 300, "k": 32}),
    ("symcon", {"N": 65, "k": 8, "nu": 2}),
    ("channelwise_tp", {"E": 147456, "k": 128}),
    ("interaction", {"E": 147456, "N": 3072, "k": 128}),
])
def test_bucket_rounds_up_to_pow2(kind, params):
    assert at.bucket_key(kind, params) == jat.bucket_key(kind, params)
    assert at.bucket_dims(kind, params) == jat.bucket_dims(kind, params)
    assert at.bucket_key("interaction", {"E": 4096, "N": 300, "k": 32}) == "E4096-N512-k32"


@pytest.mark.parametrize("a,b", [
    ({"N": 512, "k": 32}, {"N": 512, "k": 32}),
    ({"N": 512, "k": 32}, {"N": 128, "k": 32}),
    ({"N": 64, "k": 8, "nu": 2}, {"N": 64, "k": 8, "nu": 3}),
    ({"N": 64, "k": 8, "nu": 2}, {"N": 64, "k": 8}),
])
def test_bucket_distance_is_max_log2_ratio(a, b):
    assert at.bucket_distance(a, b) == jat.bucket_distance(a, b)


# ---------------------------------------------------------------------------
# decide(): measured rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_decide_honors_clear_measured_winner(jp, pp):
    runs = [_run([
        _row("interaction", "ref", "fwd_bwd", 300.0, blocked=False, **Q_INT),
        _row("interaction", "fused", "fwd_bwd", 100.0, blocked=False, **Q_INT),
    ], backend=jp)]
    d = _both_decide("interaction", Q_INT, jp, pp, runs=runs)
    assert (d.impl, d.source, d.block_n) == ("fused", "measured", None)


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_decide_newest_row_wins_per_config(jp, pp):
    old = _run([
        _row("interaction", "fused", "fwd_bwd", 10.0, blocked=False, **Q_INT),
        _row("interaction", "ref", "fwd_bwd", 500.0, blocked=False, **Q_INT),
    ], backend=jp)
    new = _run([
        _row("interaction", "fused", "fwd_bwd", 400.0, blocked=False, **Q_INT),
        _row("interaction", "ref", "fwd_bwd", 200.0, blocked=False, **Q_INT),
    ], backend=jp)
    d = _both_decide("interaction", Q_INT, jp, pp, runs=[old, new])
    assert (d.impl, d.score_us) == ("ref", pytest.approx(200.0))


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_decide_tied_rows_break_to_preference_order(jp, pp):
    runs = [_run([
        _row("interaction", "ref", "fwd_bwd", 100.0, blocked=False, **Q_INT),
        _row("interaction", "fused", "fwd_bwd", 100.9, blocked=False, **Q_INT),
    ], backend=jp)]
    assert _both_decide("interaction", Q_INT, jp, pp, runs=runs).impl == "fused"


def test_decide_tied_kernel_rows_break_to_cuda_over_ref_and_default_tiles():
    """On the accelerator: within TIE_RTOL the kernel beats ref, and the
    default 32x128 tile beats another geometry and bwd cuda beats fused."""
    rows = [
        _row("interaction", "ref", "fwd_bwd", 100.0, blocked=False, **Q_INT),
        _row("interaction", "pallas", "fwd_bwd", 100.5, blocked=True, block_n=16,
             block_e=128, bwd_impl="xla", **Q_INT),
        _row("interaction", "pallas", "fwd_bwd", 101.0, blocked=True, block_n=32,
             block_e=128, bwd_impl="pallas", **Q_INT),
    ]
    d = _both_decide("interaction", Q_INT, *ACCEL, runs=[_run(rows, backend="tpu")])
    assert (d.impl, d.block_n, d.block_e, d.bwd_impl) == ("cuda", 32, 128, "cuda")


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_decide_ignores_other_platform_and_mode_rows(jp, pp, jax_peaks):
    other = "tpu" if jp == "cpu" else "cpu"
    runs = [
        _run([_row("interaction", "ref", "fwd_bwd", 1.0, blocked=False, **Q_INT)],
             backend=other),
        _run([_row("interaction", "ref", "fwd", 1.0, blocked=False, **Q_INT)], backend=jp),
    ]
    assert _both_decide("interaction", Q_INT, jp, pp, runs=runs).source == "roofline"


def test_decide_interpret_mode_rows_cannot_win():
    runs = [_run([
        _row("interaction", "pallas", "fwd_bwd", 1.0, blocked=True, **Q_INT),
        _row("interaction", "fused", "fwd_bwd", 100.0, blocked=False, **Q_INT),
        _row("interaction", "ref", "fwd_bwd", 150.0, blocked=False, **Q_INT),
    ])]
    assert _both_decide("interaction", Q_INT, "cpu", "cpu", runs=runs).impl == "fused"
    assert "cuda" not in at.viable_candidates("interaction", "cpu", "fwd_bwd")
    assert "cuda" in at.viable_candidates("interaction", "gpu", "fwd_bwd")


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_decide_near_match_bucket_answers_for_unmeasured_shape(jp, pp):
    runs = [_run([
        _row("interaction", "ref", "fwd_bwd", 300.0, blocked=False, **Q_INT),
        _row("interaction", "fused", "fwd_bwd", 100.0, blocked=False, **Q_INT),
    ], backend=jp)]
    near = {"E": 512, "N": 128, "k": 8}  # within 2 pow2 steps per dim
    d = _both_decide("interaction", near, jp, pp, runs=runs)
    assert (d.impl, d.source) == ("fused", "measured")


@pytest.mark.parametrize("jp,pp", PLATFORMS)
@pytest.mark.parametrize("kind,far", [
    ("interaction", {"E": 65536, "N": 4096, "k": 128}),
    ("interaction", {"E": 147456, "N": 3072, "k": 128}),
    ("symcon", {"N": 3072, "k": 128, "nu": 2}),
    ("channelwise_tp", {"E": 12288, "k": 128}),
])
def test_decide_missing_shape_falls_back_to_roofline(jp, pp, kind, far, jax_peaks):
    runs = [_run([
        _row("interaction", "fused", "fwd_bwd", 100.0, blocked=False, **Q_INT),
    ], backend=jp)]
    for mode in at.MODES:
        d = _both_decide(kind, far, jp, pp, mode=mode, runs=runs)
        assert d.source == "roofline" and d.score_us > 0
        assert d.impl in at.viable_candidates(kind, pp, mode)


def test_roofline_on_the_h100_peaks_picks_the_kernels_at_the_main_path_shapes():
    """With the H100's own peaks (unpatched) the model ranks the cuda
    kernels, with the backward kernel, first at every main-path shape."""
    assert at.ROOFLINE_PEAKS["gpu"] == (67e12, 3.35e12)
    for kind, shapes in at.CANONICAL_SHAPES.items():
        for params in shapes:
            if params["k"] == 128:
                d = at.decide(kind, params, "gpu", "fwd_bwd", runs=[])
                assert (d.impl, d.bwd_impl, d.source) == ("cuda", "cuda", "roofline"), d


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_stale_schema_trajectory_is_ignored(tmp_path, jp, pp, jax_peaks):
    run = _run([_row("symcon", "ref", "fwd_bwd", 1.0, **Q_SC)], backend=jp)
    p = tmp_path / "bench.json"
    p.write_text(json.dumps({"schema": 99, "runs": [to_port(run)]}))
    assert at.load_trajectory(p) == []
    d = _both_decide("symcon", Q_SC, jp, pp, runs=at.load_trajectory(p))
    assert d.source == "roofline"


def test_legacy_blocked_rows_normalize_to_default_tiles():
    row = _row("interaction", "pallas", "fwd_bwd", 50.0, blocked=True, **Q_INT)
    want = jat.measured_scores([_run([row], backend="tpu")], "interaction", "tpu",
                               "fwd_bwd", Q_INT)
    got = at.measured_scores(_ported([_run([row], backend="tpu")]), "interaction", "gpu",
                             "fwd_bwd", Q_INT)
    assert ("pallas", 32, 128, "pallas", "fp32") in want
    assert got == {("cuda", 32, 128, "cuda", "fp32"): want[("pallas", 32, 128, "pallas", "fp32")]}


def test_rows_without_a_time_are_no_evidence():
    """A candidate that ran out of memory leaves a row with ``us`` None and
    ``failed``; the decision is made among the measured ones."""
    rows = [
        {**_row("interaction", "fused", "fwd_bwd", 1.0, blocked=False, **Q_INT),
         "us": None, "seconds": None, "failed": "out of memory"},
        _row("interaction", "ref", "fwd_bwd", 300.0, blocked=False, **Q_INT),
    ]
    d = _both_decide("interaction", Q_INT, "cpu", "cpu", runs=[_run(rows)])
    assert (d.impl, d.source) == ("ref", "measured")


# ---------------------------------------------------------------------------
# the committed table: build / lookup / check
# ---------------------------------------------------------------------------


def _cpu_runs(backend="cpu"):
    return [_run([
        _row("symcon", "ref", "fwd_bwd", 220.0, **Q_SC),
        _row("symcon", "fused", "fwd_bwd", 120.0, **Q_SC),
        _row("symcon", "ref", "fwd", 80.0, **Q_SC),
        _row("symcon", "fused", "fwd", 60.0, **Q_SC),
        _row("channelwise_tp", "ref", "fwd_bwd", 400.0, E=256, k=8),
        _row("channelwise_tp", "fused", "fwd_bwd", 150.0, E=256, k=8),
        _row("channelwise_tp", "ref", "fwd", 90.0, E=256, k=8),
        _row("channelwise_tp", "fused", "fwd", 70.0, E=256, k=8),
        _row("interaction", "ref", "fwd_bwd", 500.0, blocked=False, **Q_INT),
        _row("interaction", "fused", "fwd_bwd", 200.0, blocked=False, **Q_INT),
        _row("interaction", "ref", "fwd", 100.0, blocked=False, **Q_INT),
        _row("interaction", "fused", "fwd", 90.0, blocked=False, **Q_INT),
    ], backend=backend)]


def _write_trajectories(tmp_path, runs):
    """The JAX trajectory file and its port counterpart."""
    jp, pp = tmp_path / "jax_bench.json", tmp_path / "port_bench.json"
    jp.write_text(json.dumps({"schema": 1, "runs": runs}))
    pp.write_text(json.dumps({"schema": 1, "runs": _ported(runs)}))
    return jp, pp


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_build_write_load_lookup_roundtrip(tmp_path, jp, pp, jax_peaks):
    jtraj, ptraj = _write_trajectories(tmp_path, _cpu_runs(jp))
    with mock.patch.object(at, "CANONICAL_SHAPES", jat.CANONICAL_SHAPES):
        payload = at.build_table(platforms=[pp], trajectory_path=ptraj)
    _same_entries(jat.build_table(platforms=[jp], trajectory_path=jtraj), payload)
    path = at.write_table(payload, tmp_path / "tuning_table.json")
    table = at.load_table(path)
    assert table is not None and table["schema"] == at.SCHEMA
    for q in (Q_INT, {"E": 300, "N": 100, "k": 8}):
        d = at.lookup(table, "interaction", q, pp, "fwd_bwd")
        assert d is not None and (d.impl, d.source) == ("fused", "measured")
        _same(jat.lookup(jat.build_table(platforms=[jp], trajectory_path=jtraj),
                         "interaction", q, jp, "fwd_bwd"), d)
    keys = [(e["platform"], e["kind"], e["mode"], e.get("precision", "fp32"), e["bucket"])
            for e in table["entries"]]
    assert keys == sorted(keys)


def test_build_table_covers_the_main_path_shapes():
    """The port's canonical shapes are the JAX ones plus the main paths' at
    the paper's width: serving buckets of 64 and 256 atoms and the
    3,072-atom training bin, edge_factor 48, 128 channels."""
    for kind, shapes in jat.CANONICAL_SHAPES.items():
        assert at.CANONICAL_SHAPES[kind][:len(shapes)] == shapes
    main = {kind: [s for s in shapes if s["k"] == 128]
            for kind, shapes in at.CANONICAL_SHAPES.items()}
    assert main["interaction"] == [{"E": 48 * n, "N": n, "k": 128} for n in (64, 256, 3072)]
    assert main["symcon"] == [{"N": n, "k": 128, "nu": 2} for n in (64, 256, 3072)]
    assert main["channelwise_tp"] == [{"E": 48 * n, "k": 128} for n in (64, 256, 3072)]


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_lookup_rejects_no_longer_viable_impl(jp, pp):
    entry = {"kind": "interaction", "platform": jp, "mode": "fwd_bwd",
             "bucket": "E256-N64-k8", "dims": {"E": 256, "N": 64, "k": 8},
             "impl": "pallas_bf16", "block_n": 32, "block_e": 128,
             "bwd_impl": "pallas", "source": "measured", "score_us": 1.0}
    table = {"schema": 1, "entries": [entry]}
    assert jat.lookup(table, "interaction", Q_INT, jp, "fwd_bwd") is None
    assert at.lookup(to_port(table), "interaction", Q_INT, pp, "fwd_bwd") is None
    if jp == "cpu":  # the kernel itself is not a candidate on the CPU
        table = {"schema": 1, "entries": [dict(entry, impl="pallas")]}
        assert at.lookup(to_port(table), "interaction", Q_INT, "cpu", "fwd_bwd") is None


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_check_table_healthy_and_failure_modes(tmp_path, jp, pp):
    jtraj, ptraj = _write_trajectories(tmp_path, _cpu_runs(jp))
    tpath = at.write_table(at.build_table(platforms=[pp], trajectory_path=ptraj),
                           tmp_path / "tuning_table.json")
    assert at.check_table(pp, table_path=tpath, trajectory_path=ptraj) == []
    assert at.check_table(pp, table_path=tmp_path / "nope.json", trajectory_path=ptraj)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 0, "entries": []}))
    assert at.check_table(pp, table_path=bad, trajectory_path=ptraj)
    table = json.loads(tpath.read_text())
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({"schema": 1, "entries": [
        e for e in table["entries"] if e["kind"] != "symcon"]}))
    problems = at.check_table(pp, table_path=partial, trajectory_path=ptraj)
    assert any("symcon" in msg for msg in problems)
    # the JAX check of the same files agrees on each verdict
    jtable = at.write_table(jat.build_table(platforms=[jp], trajectory_path=jtraj),
                            tmp_path / "jax_table.json")
    jpartial = tmp_path / "jax_partial.json"
    jpartial.write_text(json.dumps({"schema": 1, "entries": [
        e for e in json.loads(jtable.read_text())["entries"] if e["kind"] != "symcon"]}))
    assert jat.check_table(jp, table_path=jtable, trajectory_path=jtraj) == []
    assert len(jat.check_table(jp, table_path=jpartial, trajectory_path=jtraj)) == len(problems)


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_check_table_flags_stale_decision(tmp_path, jp, pp):
    """Newer evidence flips the interaction winner by > STALE_FACTOR: both
    packages flag the table built before it, and clear one rebuilt."""
    jtraj, ptraj = _write_trajectories(tmp_path, _cpu_runs(jp))
    tables = {"jax": jat.build_table(platforms=[jp], trajectory_path=jtraj),
              "port": at.build_table(platforms=[pp], trajectory_path=ptraj)}
    flipped = _run([
        _row("interaction", "ref", "fwd_bwd", 100.0, blocked=False, **Q_INT),
        _row("interaction", "fused", "fwd_bwd", 500.0, blocked=False, **Q_INT),
    ], backend=jp)
    jtraj2, ptraj2 = _write_trajectories(tmp_path, _cpu_runs(jp) + [flipped])
    for side, mod, platform, traj2 in (("jax", jat, jp, jtraj2), ("port", at, pp, ptraj2)):
        tpath = mod.write_table(tables[side], tmp_path / f"{side}_table.json")
        problems = mod.check_table(platform, table_path=tpath, trajectory_path=traj2)
        assert any("stale" in msg for msg in problems), side
        tpath = mod.write_table(mod.build_table(platforms=[platform], trajectory_path=traj2),
                                tpath)
        assert mod.check_table(platform, table_path=tpath, trajectory_path=traj2) == []


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_committed_table_is_valid(platform):
    """The port's committed ``tuning_table.json`` passes check mode against
    its committed trajectory."""
    assert at.DEFAULT_TABLE_PATH.exists(), "tuning_table.json not committed"
    assert at.check_table(platform) == []


@pytest.mark.parametrize("kind", at.KINDS)
def test_committed_gpu_entries_on_the_main_paths_are_measured_on_the_h100(kind):
    """Every fp32 ``gpu`` entry at a main-path shape (128 channels) comes
    from a trajectory row timed on an H100, in a run record that names the
    card and its power limit."""
    table, runs = at.load_table(), at.load_trajectory()
    cards = [r["card"] for r in runs if r.get("backend") == "gpu"]
    assert cards and all("H100" in c and c.endswith("W") for c in cards), cards
    for params in at.CANONICAL_SHAPES[kind]:
        if params["k"] != 128:
            continue
        for mode in at.MODES:
            d = at.lookup(table, kind, params, "gpu", mode)
            assert d is not None and d.source == "measured", (params, mode, d)
            assert at.measured_scores(runs, kind, "gpu", mode, params, max_dist=0.0)


# ---------------------------------------------------------------------------
# impl="auto" resolution
# ---------------------------------------------------------------------------


def _resolved_fields(cfg, jax_side):
    impl, inter, bwd = cfg.impl, cfg.interaction_impl, cfg.interaction_bwd_impl
    if jax_side:
        impl, inter = JAX_IMPL_NAMES[impl], JAX_IMPL_NAMES[inter]
        bwd = JAX_BWD_IMPL_NAMES[bwd]
    return impl, inter, bwd, cfg.interaction_block_n, cfg.precision


def _both_resolve(fields, table, jp, pp, **kw):
    jcfg, jdec = jat.resolve_mace_config(JMaceConfig(**fields), platform=jp,
                                         table=table, **kw)
    pcfg, pdec = at.resolve_mace_config(
        MaceConfig(**fields), platform=pp,
        table=None if table is None else to_port(table), **kw)
    assert _resolved_fields(pcfg, False) == _resolved_fields(jcfg, True)
    assert sorted(pdec) == sorted(jdec)
    for kind in jdec:
        _same(jdec[kind], pdec[kind])
    return pcfg, pdec


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_resolve_replaces_auto_sentinels(tmp_path, jp, pp, jax_peaks):
    jtraj, _ = _write_trajectories(tmp_path, _cpu_runs(jp))
    table = jat.build_table(platforms=[jp], trajectory_path=jtraj)
    cfg = MaceConfig(channels=8, impl="auto", interaction_impl="auto")
    assert at.needs_resolution(cfg)
    resolved, decisions = _both_resolve(
        dict(channels=8, impl="auto", interaction_impl="auto"), table, jp, pp,
        capacity=64, edge_factor=4)
    assert set(decisions) == {"symcon", "channelwise_tp", "interaction"}
    assert decisions["symcon"].impl == decisions["channelwise_tp"].impl == resolved.impl
    assert decisions["interaction"].impl == resolved.interaction_impl
    assert (resolved.impl, resolved.interaction_impl) == ("fused", "fused")


def test_resolve_without_auto_is_identity():
    cfg = MaceConfig(impl="fused", interaction_impl="ref")
    assert not at.needs_resolution(cfg)
    resolved, decisions = at.resolve_mace_config(cfg, capacity=64, edge_factor=4,
                                                 platform="cpu", table=None)
    assert resolved is cfg and decisions == {}
    jcfg = JMaceConfig(impl="fused", interaction_impl="ref")
    assert jat.resolve_mace_config(jcfg, capacity=64, edge_factor=4, platform="cpu",
                                   table=None) == (jcfg, {})


def test_resolve_adopts_tile_geometry_on_the_accelerator():
    table = {"schema": 1, "entries": [{
        "kind": "interaction", "platform": "tpu", "mode": "fwd_bwd",
        "bucket": "E256-N64-k8", "dims": {"E": 256, "N": 64, "k": 8},
        "impl": "pallas", "block_n": 16, "block_e": 256,
        "bwd_impl": "xla", "source": "measured", "score_us": 5.0,
    }]}
    resolved, decisions = _both_resolve(
        dict(channels=8, impl="fused", interaction_impl="auto"), table, *ACCEL,
        capacity=64, edge_factor=4)
    assert (resolved.interaction_impl, resolved.interaction_block_n,
            resolved.interaction_bwd_impl) == ("cuda", 16, "fused")
    assert decisions["interaction"].block_e == 256


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_resolve_no_table_uses_roofline(tmp_path, jp, pp, jax_peaks):
    jcfg, jdec = jat.resolve_mace_config(
        JMaceConfig(channels=8, interaction_impl="auto"), capacity=64, edge_factor=4,
        platform=jp, table_path=tmp_path / "missing.json")
    pcfg, pdec = at.resolve_mace_config(
        MaceConfig(channels=8, interaction_impl="auto"), capacity=64, edge_factor=4,
        platform=pp, table_path=tmp_path / "missing.json")
    _same(jdec["interaction"], pdec["interaction"])
    assert pdec["interaction"].source == "roofline"
    assert pcfg.interaction_impl in at.viable_candidates("interaction", pp, "fwd_bwd")


@settings(max_examples=20, deadline=None)
@given(
    capacity=st.sampled_from([32, 64, 128, 256, 512, 3072]),
    edge_factor=st.sampled_from([4, 16, 48]),
    channels=st.sampled_from([4, 8, 32, 128]),
    platforms=st.sampled_from(PLATFORMS),
)
def test_resolution_is_deterministic_for_fixed_table(capacity, edge_factor, channels,
                                                     platforms):
    """Resolution is a pure function of (config, shape bucket, platform,
    table): on the port's committed table two calls agree exactly, and on
    the JAX committed table, mapped, the port decides as the JAX tuner."""
    jp, pp = platforms
    table = at.load_table()
    cfg = MaceConfig(channels=channels, impl="auto", interaction_impl="auto")
    kw = dict(capacity=capacity, edge_factor=edge_factor, platform=pp, table=table)
    a, b = at.resolve_mace_config(cfg, **kw), at.resolve_mace_config(cfg, **kw)
    assert a == b
    assert a[0].impl != "auto" and a[0].interaction_impl != "auto"
    with mock.patch.dict(at.ROOFLINE_PEAKS, {"gpu": jat.ROOFLINE_PEAKS["tpu"]}):
        _both_resolve(dict(channels=channels, impl="auto", interaction_impl="auto"),
                      jat.load_table(), jp, pp, capacity=capacity,
                      edge_factor=edge_factor)


# ---------------------------------------------------------------------------
# precision keying: reduced-precision rows never shadow fp32
# ---------------------------------------------------------------------------


def test_measured_rows_key_by_precision():
    rows = [_row("symcon", "pallas", "fwd_bwd", 40.0, **Q_SC),
            _row("symcon", "pallas_bf16", "fwd_bwd", 20.0, **Q_SC)]
    want = jat.measured_scores([_run(rows, backend="tpu")], "symcon", "tpu", "fwd_bwd", Q_SC)
    got = at.measured_scores(_ported([_run(rows, backend="tpu")]), "symcon", "gpu",
                             "fwd_bwd", Q_SC)
    assert got == {("cuda", None, None, "cuda", "fp32"): want[("pallas", None, None, "pallas", "fp32")],
                   ("cuda_bf16", None, None, "cuda", "bf16"):
                       want[("pallas_bf16", None, None, "pallas", "bf16")]}


@pytest.mark.parametrize("kind", at.KINDS)
def test_viable_candidates_partition_by_precision(kind):
    for jp, pp in PLATFORMS:
        for mode in at.MODES:
            for prec in ("fp32", "bf16", "fp8"):
                assert at.viable_candidates(kind, pp, mode, prec) == sorted(
                    JAX_IMPL_NAMES[n] for n in jat.viable_candidates(kind, jp, mode, prec))
    fp32 = at.viable_candidates(kind, "gpu", "fwd_bwd")
    assert "cuda" in fp32 and "cuda_bf16" not in fp32
    assert at.viable_candidates(kind, "gpu", "fwd_bwd", "bf16") == ["cuda_bf16"]
    assert at.viable_candidates(kind, "cpu", "fwd_bwd", "bf16") == ["cuda_bf16"]
    assert "cuda" not in at.viable_candidates(kind, "cpu", "fwd_bwd")


def test_lookup_never_crosses_precision():
    table = {"schema": 1, "entries": [
        {"kind": "symcon", "platform": "tpu", "mode": "fwd_bwd",
         "bucket": "N512-k32-nu3", "dims": {"N": 512, "k": 32, "nu": 3},
         "impl": "pallas_bf16", "block_n": None, "block_e": None,
         "bwd_impl": "pallas", "precision": "bf16", "source": "measured", "score_us": 10.0},
        {"kind": "symcon", "platform": "tpu", "mode": "fwd_bwd",
         "bucket": "N1024-k32-nu3", "dims": {"N": 1024, "k": 32, "nu": 3},
         "impl": "pallas", "block_n": None, "block_e": None,
         "bwd_impl": "pallas", "source": "measured", "score_us": 20.0},
    ]}
    q = {"N": 512, "k": 32, "nu": 3}
    for prec in ("fp32", "bf16"):
        jd = jat.lookup(table, "symcon", q, "tpu", "fwd_bwd", precision=prec)
        pd = at.lookup(to_port(table), "symcon", q, "gpu", "fwd_bwd", precision=prec)
        _same(jd, pd)
    d32 = at.lookup(to_port(table), "symcon", q, "gpu", "fwd_bwd")
    assert (d32.impl, d32.bucket) == ("cuda", "N1024-k32-nu3")
    assert at.lookup(to_port(table), "symcon", q, "gpu", "fwd_bwd", precision="fp8") is None


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_decide_and_build_table_cover_precisions(tmp_path, jp, pp, jax_peaks):
    d = _both_decide("symcon", Q_SC, jp, pp, precision="bf16")
    assert (d.impl, d.precision) == ("cuda_bf16", "bf16")
    with mock.patch.object(at, "CANONICAL_SHAPES", jat.CANONICAL_SHAPES):
        payload = at.build_table(platforms=[pp], trajectory_path=tmp_path / "none.json")
    _same_entries(jat.build_table(platforms=[jp], trajectory_path=tmp_path / "none.json"),
                  payload)
    assert {e["precision"] for e in payload["entries"]} == set(at.TABLE_PRECISIONS)
    assert all(e["impl"].endswith("_bf16") for e in payload["entries"]
               if e["precision"] == "bf16")
    tpath = at.write_table(payload, tmp_path / "tuning_table.json")
    assert at.check_table(pp, table_path=tpath, trajectory_path=tmp_path / "none.json") == []


@pytest.mark.parametrize("jp,pp", PLATFORMS)
def test_resolve_mace_config_auto_at_bf16_selects_variants(jp, pp, jax_peaks):
    fields = dict(n_species=10, channels=8, hidden_ls=(0, 1), sh_lmax=2, a_ls=(0, 1, 2),
                  correlation=2, n_interactions=2, avg_num_neighbors=8.0, impl="auto",
                  interaction_impl="auto", precision="bf16")
    resolved, decisions = _both_resolve(fields, {"schema": 1, "entries": []}, jp, pp,
                                        capacity=64, edge_factor=16)
    assert (resolved.impl, resolved.interaction_impl) == ("cuda_bf16", "cuda_bf16")
    assert resolved.symcon_impl_name == "cuda_bf16"
    assert all(d.precision == "bf16" for d in decisions.values())


# ---------------------------------------------------------------------------
# the cost model, and the card's constants
# ---------------------------------------------------------------------------


def _cost_shapes(kind):
    shapes = [dict(s) for s in at.CANONICAL_SHAPES[kind]]
    if kind == "interaction":  # every tile geometry the tuner offers
        from repro_torch.data.blocking import block_size_candidates

        shapes += [dict(s, block_n=bn, block_e=be) for s in at.CANONICAL_SHAPES[kind]
                   for bn, be in block_size_candidates(s["N"], s["E"])]
    return shapes


@pytest.mark.parametrize("mode", at.MODES)
@pytest.mark.parametrize("jimpl", ["ref", "fused", "pallas"])
@pytest.mark.parametrize("kind", at.KINDS)
def test_kernel_cell_cost_equals_jax_exactly(kind, jimpl, mode):
    for shape in _cost_shapes(kind):
        got = kernel_cell_cost(kind, JAX_IMPL_NAMES[jimpl], shape, mode=mode)
        assert got == jax_cell_cost(kind, jimpl, shape, mode=mode), shape


def test_symcon_flops_and_roofline_terms_are_the_cards():
    from repro.core.symmetric_contraction import SymConSpec as JSpec
    from repro.core.symmetric_contraction import symcon_flops as jflops
    from repro.core.irreps import lspec as jlspec
    from repro_torch.core.irreps import lspec
    from repro_torch.core.symmetric_contraction import SymConSpec, symcon_flops
    from repro_torch.roofline import HW

    for nu in (1, 2, 3):
        assert symcon_flops(SymConSpec(lspec(0, 1, 2), lspec(0, 1), nu), 64, 8) == jflops(
            JSpec(jlspec(0, 1, 2), jlspec(0, 1), nu), 64, 8)
    hw = HW()
    assert (hw.peak_flops_fp32, hw.hbm_bw) == (67e12, 3.35e12)
    assert at.ROOFLINE_PEAKS["gpu"] == (hw.peak_flops_fp32, hw.hbm_bw)
    # the roofline score is the larger of its two terms, against the card's peaks
    shape = {"N": 256, "k": 128, "nu": 2}
    cell = kernel_cell_cost("symcon", "cuda", shape, mode="fwd")
    want = max(cell["flops"] / hw.peak_flops_fp32, cell["hbm_bytes"] / hw.hbm_bw) * 1e6
    assert at.roofline_score_us("symcon", "cuda", shape, "gpu", "fwd") == want


def test_block_candidates_never_exceed_the_kernels_tile():
    """The forward kernel sorts at most MAX_EPB slots a tile: the tuner
    prunes a geometry past it (the fallback of a shape too small for the
    grid would otherwise offer one)."""
    from repro_torch.kernels.channelwise_tp.kernel import MAX_EPB

    assert at._block_candidates_for("interaction", "cuda", {"N": 4, "E": 4096}, None) == [
        (4, MAX_EPB)]
    cands = at._block_candidates_for("interaction", "cuda", {"N": 3072, "E": 147456}, None)
    assert cands == jat._block_candidates_for("interaction", "pallas",
                                              {"N": 3072, "E": 147456}, None)
    assert all(be <= MAX_EPB for _, be in cands)


# ---------------------------------------------------------------------------
# MaceConfig: "auto"
# ---------------------------------------------------------------------------


def test_mace_config_auto_follows_jax_name_semantics():
    cfg = MaceConfig(impl="fused", interaction_impl="auto")
    jcfg = JMaceConfig(impl="fused", interaction_impl="auto")
    assert cfg.interaction_impl_name == jcfg.interaction_impl_name == "fused"
    cfg = MaceConfig(impl="cuda", interaction_impl="auto", precision="bf16")
    assert cfg.interaction_impl_name == "cuda_bf16"
    raw = MaceConfig(impl="auto")
    assert raw.symcon_impl_name == "auto"
    from repro_torch.kernels.registry import resolve

    with pytest.raises(KeyError):
        resolve("symcon", raw.symcon_impl_name, raw.symcon_spec())


# ---------------------------------------------------------------------------
# the build paths resolve "auto": Trainer, make_engine, ServeEngine, GraphServer
# ---------------------------------------------------------------------------

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2, a_ls=(0, 1, 2),
              correlation=2, n_interactions=2, avg_num_neighbors=8.0)
TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8)


def _trainer(cfg, **tcfg):
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    return Trainer(cfg, TrainerConfig(**TRAIN, **tcfg),
                   SyntheticCFMDataset(24, seed=0, max_atoms=24), seed=0, device="cpu")


def test_trainer_auto_matches_the_resolved_names_bit_for_bit():
    auto = _trainer(MaceConfig(**WIDTHS, impl="cuda"), impl="auto", interaction_impl="auto")
    decisions = auto.autotune_decisions
    assert set(decisions) == {"symcon", "channelwise_tp", "interaction"}
    want = at.resolve_mace_config(
        MaceConfig(**WIDTHS, impl="auto", interaction_impl="auto"), platform="cpu",
        capacity=TRAIN["capacity"], edge_factor=TRAIN["edge_factor"])
    assert auto.mace_cfg == want[0] and decisions == want[1]
    d = decisions["interaction"]
    explicit = _trainer(
        MaceConfig(**WIDTHS, impl=decisions["symcon"].impl, interaction_impl=d.impl,
                   interaction_bwd_impl=d.bwd_impl or "cuda",
                   interaction_block_n=d.block_n or 32),
        **({} if d.block_n is None else dict(block_n=d.block_n, block_e=d.block_e)))
    assert explicit.autotune_decisions == {}
    assert explicit.mace_cfg == auto.mace_cfg and explicit.bin_shape == auto.bin_shape
    a = [h["loss"] for h in auto.train(n_epochs=1, max_steps=2)["history"]]
    b = [h["loss"] for h in explicit.train(n_epochs=1, max_steps=2)["history"]]
    assert len(a) == 2 and a == b


def test_trainer_adopts_the_interaction_decisions_tile_geometry(tmp_path):
    """A table that picks a blocked impl at another geometry: the BinShape
    and the model's block_n follow the decision (the CPU runs the cuda
    impl's plain versions, so a reduced precision makes it a candidate)."""
    table = {"schema": 1, "entries": [{
        "kind": "interaction", "platform": "cpu", "mode": "fwd_bwd", "precision": "bf16",
        "bucket": "E1024-N64-k4", "dims": {"E": 1024, "N": 64, "k": 4},
        "impl": "cuda_bf16", "block_n": 16, "block_e": 256, "bwd_impl": "fused",
        "source": "measured", "score_us": 5.0}]}
    path = tmp_path / "tuning_table.json"
    path.write_text(json.dumps(table))
    with mock.patch.object(at, "DEFAULT_TABLE_PATH", path):
        tr = _trainer(MaceConfig(**WIDTHS, impl="cuda", interaction_impl="auto"),
                      precision="bf16")
    assert (tr.mace_cfg.interaction_impl, tr.mace_cfg.interaction_block_n,
            tr.mace_cfg.interaction_bwd_impl) == ("cuda_bf16", 16, "fused")
    assert (tr.bin_shape.block_n, tr.bin_shape.block_e) == (16, 256)
    assert np.isfinite(tr.train(n_epochs=1, max_steps=1)["history"][0]["loss"])


@pytest.mark.parametrize("pinned", [(8, 256), (64, 128)])
def test_make_engine_resolves_auto_pinned_to_the_collation_geometry(pinned):
    """The committed table's cpu bf16 entry may name another geometry than
    the collation's: the engine keeps the collation's either way."""
    from repro_torch.train.engine import make_engine
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_loop import TrainerConfig

    tcfg = TrainerConfig(**TRAIN, block_n=pinned[0], block_e=pinned[1])
    eng = make_engine("sequential", MaceConfig(**WIDTHS, interaction_impl="auto",
                                                precision="bf16"),
                      tcfg, adamw(1e-3), 8, torch.device("cpu"))
    assert eng.mace_cfg.interaction_impl == "cuda_bf16"
    assert eng.mace_cfg.interaction_block_n == pinned[0]


def test_pinned_geometry_takes_the_measured_rows_at_its_tiles():
    """A caller pinned to other tiles than the committed gpu entry's for
    the 256-atom bucket resolves from the H100's rows at its own tiles,
    not from the roofline."""
    dims = {"E": 12288, "N": 256, "k": 128}
    entry = at.lookup(at.load_table(), "interaction", dims, "gpu", "fwd_bwd")
    pinned = (64, 128) if (entry.block_n, entry.block_e) != (64, 128) else (32, 128)
    resolved, decisions = at.resolve_mace_config(
        MaceConfig(channels=128, interaction_impl="auto"), capacity=256, edge_factor=48,
        platform="gpu", block_candidates=[pinned])
    d = decisions["interaction"]
    assert (d.source, d.block_n, d.block_e) == ("measured", *pinned)
    assert resolved.interaction_block_n == pinned[0]
    measured = at.measured_scores(at.load_trajectory(), "interaction", "gpu", "fwd_bwd", dims)
    assert d.score_us == measured[(d.impl, *pinned, d.bwd_impl, "fp32")][0]


def _ladder_and_params(cfg):
    from repro_torch.core.mace import init_mace
    from repro_torch.serve import bucket_ladder

    return (bucket_ladder((24, 48), edge_factor=48),
            init_mace(cfg, torch.Generator().manual_seed(0)))


def test_serve_engine_resolves_auto_before_warmup():
    from repro_torch.serve import ServeEngine

    cfg = MaceConfig(**WIDTHS, impl="auto", interaction_impl="auto")
    ladder, params = _ladder_and_params(dataclasses.replace(cfg, impl="fused"))
    want, _ = at.resolve_mace_config(cfg, capacity=48, edge_factor=48, platform="cpu",
                                     block_candidates=[(32, 128)])
    with ServeEngine(cfg, params, ladder, device="cpu") as eng:
        assert eng.mace_cfg == want and "auto" not in (want.impl, want.interaction_impl)
        eng.warmup()
        assert set(eng.compile_census().values()) == {0}


def test_graph_server_resolves_auto_and_reports_the_decisions():
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.serve import GraphServer, ServeConfig

    cfg = MaceConfig(**WIDTHS, impl="cuda", interaction_impl="auto")
    _, params = _ladder_and_params(cfg)
    ds = SyntheticCFMDataset(16, seed=3, max_atoms=24)
    server = GraphServer(cfg, params, ServeConfig(capacities=(24, 48), edge_factor=48,
                                                  n_workers=1, max_wait_s=0.005),
                         device="cpu")
    try:
        d = server.autotune_decisions["interaction"]
        assert server.mace_cfg.interaction_impl == d.impl != "auto"
        assert d.platform == "cpu" and d.bucket == "E4096-N64-k4"
        results = [server.submit(ds.get(i), timeout=30.0).result(timeout=120.0)
                   for i in range(4)]
        assert all(np.isfinite(r.energy) for r in results)
        stats = server.stats()
        assert stats["served"] == 4
        assert stats["autotune_decisions"] == {"interaction": d.describe()}
    finally:
        server.close()


@pytest.mark.parametrize("module,args", [
    ("repro_torch.launch.train_mace_cfm", ["--n-graphs", "16", "--capacity", "48",
                                          "--channels", "4", "--max-atoms", "24"]),
    ("repro_torch.launch.train", ["--reduced"]),
])
def test_training_entry_points_pass_auto_and_print_each_decision(module, args, tmp_path):
    """``--impl auto`` (and ``--interaction-impl``'s default, ``auto``)
    reach the trainer, which prints one ``autotune:`` line per decision."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", "--steps", "1", "--impl", "auto",
         *args], cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(repo / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("autotune: ")]
    assert [ln.split("[")[0] for ln in lines] == [
        "autotune: symcon", "autotune: channelwise_tp", "autotune: interaction"], lines
    assert all(",cpu,fwd_bwd] -> " in ln for ln in lines)
