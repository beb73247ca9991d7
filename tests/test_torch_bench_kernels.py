"""Port parity, the kernel timing harness (``repro_torch.kernels.bench``, its
command line ``repro_torch.launch.bench_kernels``) against the JAX package's ``benchmarks/bench_kernels.py`` (trajectory
retention, the capability dump) and the row schema ``time_impl`` writes
on the CPU, where the cuda impls run their plain versions.  Timings here
are CPU timings; only their presence and sign are checked.  The card's
side (CUDA-event timing, a config that runs out of device memory) is in
``tests/test_torch_cuda.py``.
"""
import json

import pytest
import torch

from benchmarks.bench_kernels import prune_runs as jprune
from benchmarks.bench_kernels import write_bench_json as jwrite
from repro.kernels import registry as jreg
from repro_torch.bridge import JAX_IMPL_NAMES
from repro_torch.kernels import autotune as at
from repro_torch.kernels import registry
from repro_torch.kernels import bench as bk
from repro_torch.launch import bench_kernels


def _run(quick, t):
    return {"unix_time": t, "backend": "cpu", "grad": True, "quick": quick, "rows": []}


@pytest.mark.parametrize("max_runs,keep_per_key", [(50, 3), (2, 3), (50, 1), (4, 8)])
def test_prune_runs_keeps_newest_per_key_and_caps_total(max_runs, keep_per_key):
    runs = [_run(True, i) for i in range(12)] + [_run(False, 100)]
    got = bk.prune_runs(runs, max_runs=max_runs, keep_per_key=keep_per_key)
    assert got == jprune(runs, max_runs=max_runs, keep_per_key=keep_per_key)
    if (max_runs, keep_per_key) == (50, 3):
        # 3 newest quick runs + the lone full-size run, chronological order
        assert [r["unix_time"] for r in got] == [9, 10, 11, 100]


def test_write_bench_json_applies_retention(tmp_path):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    for _ in range(5):
        bk.write_bench_json([], ours, grad=True, quick=True, keep_per_key=2, device="cpu")
        jwrite([], theirs, grad=True, quick=True, keep_per_key=2)
    runs, jruns = (json.loads(p.read_text())["runs"] for p in (ours, theirs))
    assert len(runs) == len(jruns) == 2
    assert [sorted(r) for r in runs] == [sorted(set(r) - {"interpret_pallas"}
                                                | {"interpret_kernels"}) for r in jruns]
    assert all(r["backend"] == "cpu" and r["interpret_kernels"] and "card" not in r
               for r in runs)
    # a corrupt file is replaced, not fatal
    ours.write_text("{not json")
    assert len(bk.write_bench_json([], ours, grad=False, quick=True,
                                   device="cpu")["runs"]) == 1


def test_bench_kernels_capabilities_flag(capsys):
    assert bench_kernels.main(["--capabilities"]) == []
    dump = json.loads(capsys.readouterr().out)
    assert set(dump) == set(registry.KINDS)
    assert dump["interaction"]["cuda"]["platform_modes"] == {"cpu": "interpret",
                                                             "gpu": "compiled"}
    for kind in registry.KINDS:
        assert sorted(dump[kind]) == sorted(JAX_IMPL_NAMES[n] for n in jreg.capabilities(kind))


def _assert_row(row, kind, impl, mode, params):
    assert (row["kind"], row["impl"], row["mode"]) == (kind, impl, mode)
    assert row["params"] == params
    assert row["us"] > 0 and row["seconds"] == pytest.approx(row["us"] / 1e6)
    assert "failed" not in row


@pytest.mark.parametrize("impl", ["ref", "fused", "cuda"])
@pytest.mark.parametrize("kind", ["symcon", "channelwise_tp", "interaction"])
def test_time_impl_row_schema_on_the_cpu(kind, impl):
    """The JAX harness's row schema, under the port's names: a fwd and a
    fwd_bwd row per config, each with its precision; a cuda interaction
    impl gets a fwd_bwd row per backward (``cuda``, ``fused``) and records
    its tile geometry."""
    shape = bk.MATRIX_SIZES[kind][True]
    rows = bk.time_impl(kind, impl, grad=True, repeats=2, device="cpu", block_n=16,
                        block_e=128, **shape)
    params = dict(shape, precision="fp32")
    if kind == "interaction":
        blocked = impl == "cuda"
        params = {"E": 256, "N": 64, "k": 8, "blocked": blocked, "precision": "fp32",
                  **({"block_n": 16, "block_e": 128} if blocked else {})}
    if kind == "interaction" and impl == "cuda":
        assert len(rows) == 3
        _assert_row(rows[0], kind, impl, "fwd", params)
        for row, bwd in zip(rows[1:], ("cuda", "fused")):
            _assert_row(row, kind, impl, "fwd_bwd", dict(params, bwd_impl=bwd))
    else:
        assert len(rows) == 2
        _assert_row(rows[0], kind, impl, "fwd", params)
        _assert_row(rows[1], kind, impl, "fwd_bwd", params)
        assert rows[1]["fwd_bwd_over_fwd"] == pytest.approx(rows[1]["us"] / rows[0]["us"])
    assert [r["mode"] for r in bk.time_impl(kind, impl, repeats=1, device="cpu",
                                            **shape)] == ["fwd"]


def test_time_impl_precision_names_the_variant():
    rows = bk.time_impl("symcon", "cuda", precision="bf16", repeats=1, device="cpu",
                        **bk.MATRIX_SIZES["symcon"][True])
    assert rows[0]["impl"] == "cuda_bf16" and rows[0]["params"]["precision"] == "bf16"
    with pytest.raises(ValueError):
        bk.time_impl("symcon", "fused", precision="bf16", device="cpu")


def test_a_config_out_of_memory_gives_a_failed_row(monkeypatch):
    """The harness catches a device out-of-memory error per timed call (and
    nothing else): its row keeps the config and has no ``us``."""
    calls = {"n": 0}
    real = bk._value_and_grad

    def exhausting(fn, inputs):
        def run():
            calls["n"] += 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return run

    monkeypatch.setattr(bk, "_value_and_grad", exhausting)
    rows = bk.time_impl("interaction", "fused", grad=True, repeats=2, device="cpu",
                        **bk.MATRIX_SIZES["interaction"][True])
    assert calls["n"] == 1  # the warm-up raised; nothing more was run
    assert rows[0]["us"] > 0
    assert rows[1]["us"] is None and rows[1]["seconds"] is None
    assert rows[1]["failed"] == bk.OOM and rows[1]["params"]["E"] == 256
    run = {"backend": "cpu", "rows": rows + [
        dict(rows[1], impl="ref", us=10.0, seconds=1e-5, failed=None)]}
    d = at.decide("interaction", rows[1]["params"], "cpu", "fwd_bwd", runs=[run])
    assert (d.impl, d.source) == ("ref", "measured")

    monkeypatch.setattr(bk, "_value_and_grad", real)

    def broken(fn, inputs):
        def run():
            raise RuntimeError("not an out-of-memory error")
        return run

    monkeypatch.setattr(bk, "_value_and_grad", broken)
    with pytest.raises(RuntimeError, match="not an out-of-memory"):
        bk.time_impl("interaction", "fused", grad=True, device="cpu",
                     **bk.MATRIX_SIZES["interaction"][True])


def test_tune_on_the_cpu_times_only_viable_candidates(tmp_path):
    """``tune`` iterates the pruned candidate matrix shape-major (the cuda
    impls are not candidates on the CPU at fp32), appends one run to the
    trajectory, and the table built from it decides from those rows."""
    traj = tmp_path / "bench.json"
    shapes = {"interaction": [{"E": 256, "N": 64, "k": 8}], "symcon": [{"N": 64, "k": 8,
                                                                        "nu": 2}]}
    rows = at.tune(shapes, 600.0, platform="cpu", repeats=1, trajectory_path=traj)
    assert {(r["kind"], r["impl"]) for r in rows} == {
        (k, i) for k in ("interaction", "symcon") for i in ("ref", "fused")}
    runs = at.load_trajectory(traj)
    assert len(runs) == 1 and runs[0]["backend"] == "cpu" and runs[0]["grad"]
    d = at.decide("interaction", shapes["interaction"][0], "cpu", "fwd_bwd", runs=runs)
    assert d.source == "measured" and d.impl in ("ref", "fused")
    # an exhausted budget times nothing and writes nothing
    assert at.tune(shapes, -1.0, platform="cpu", trajectory_path=tmp_path / "x.json") == []
    assert not (tmp_path / "x.json").exists()


def test_autotune_cli_checks_the_committed_table(capsys):
    assert at.main(["--check", "--platform", "gpu"]) == 0
    assert at.main(["--check", "--platform", "cpu"]) == 0
    assert "tuning table OK" in capsys.readouterr().out
