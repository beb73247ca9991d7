"""The cells ``mace_mp0_large.train_bins3072`` and ``mace_cfm.train_bins768``
and the readers ``symcon_ms.train`` / ``symcon_roofline.train``: whole runs
of each cell on the CPU at the small size of test_perfbench_run.py come out
``correct``; on the card, the TF32 control comes out not correct under each
cell's limits (marked ``gpu``); each reader computes its number from a
planted stretch and spans, and gives None without them."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import calibrate, harness, run
from perfbench.tests.test_perfbench_run import drive
from repro_torch import tracing

CELLS = ["mace_mp0_large.train_bins3072", "mace_cfm.train_bins768"]


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


@pytest.mark.parametrize("cell,correlation", [("mace_mp0_large.train_bins3072", 2),
                                              ("mace_cfm.train_bins768", None)])
def test_training_runs_of_the_cells_are_correct(cell, correlation, capsys, monkeypatch):
    line = drive(cell, capsys, monkeypatch, trace=1, correlation=correlation)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"data_wait_ms.train", "edge_fill.train", "atom_fill.train",
            "mfu.train"} <= set(line["metrics"])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_of_the_cells_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    harness.prepare_environment()
    w = harness.workload(harness.benchmark(), cell)
    config = harness.data_file("configs", w["config"])
    traffic = dict(harness.data_file("traffic", w["traffic"]), n_graphs=300, pool=300)
    mix = harness.module("mixes", traffic["mix"])
    dev = harness.Device(torch.device("cuda", 0))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ctx = run.Context(seed, 1.0, False, config, traffic, dev, time.perf_counter())
        correct, checks = harness.judge(calibrate.control(ctx, mix, seed),
                                        {k: v for k, v in harness.limits_of(cell).items()
                                         if k not in ("bad_bins", "lost")})
        assert not correct, checks


# a stretch of two steps: the first-order symmetric-contraction kernels'
# device seconds and launches (2 forwards and 4 backwards a step)
SYMCON_PROFILE = {"steps": 2, "mean_atoms": 3000.0, "mean_edges": 150000.0,
                  "kernels": {"symcon_fwd": (0.004, 4), "symcon_bwd": (0.012, 8),
                              "tp_scatter_fwd": (0.1, 4), "tp_gather_bwd": (0.3, 8)}}


def plant_symcon(config):
    """One ``model.symcon`` span with the counters of ``config``'s spec."""
    sp = tracing.start("model.symcon", t0=0.0)
    for key, n in (("rows", 3008), ("channels", config["channels"]),
                   ("hidden_lmax", max(config["hidden_ls"])), ("a_lmax", max(config["a_ls"])),
                   ("correlation", config["correlation"])):
        sp.count(key, n)
    sp.end(0.001)


def test_symcon_ms_reads_the_first_order_kernels_device_time_a_step():
    read = harness.module("metrics", "symcon_ms.train").read
    assert read({"profile": SYMCON_PROFILE}) == pytest.approx(8.0)
    idle = dict(SYMCON_PROFILE, kernels={"symcon_fwd": (0.0, 0), "symcon_bwd": (0.0, 0)})
    assert read({"profile": idle}) is None
    assert read({}) is None


@pytest.mark.parametrize("config", ["mace_mp0_medium", "mace_mp0_large"])
def test_symcon_roofline_takes_the_spec_from_the_spans_counters(config):
    """The share is the bound of each launch at the stretch's mean atoms
    (``counts/kernels.py``, on the configuration the counters name) over
    the launches' device time; None without the span or the stretch."""
    from perfbench.counts import kernels as kcounts
    from perfbench.reference import mace

    read = harness.module("metrics", "symcon_roofline.train").read
    record = {"profile": SYMCON_PROFILE}
    assert read(record) is None
    fields = harness.data_file("configs", config)
    tracing.enable()
    plant_symcon(fields)
    tracing.enable(False)
    assert read({}) is None
    cfg = mace.Config.from_fields(fields)
    bound = sum(SYMCON_PROFILE["kernels"][k][1] * kcounts.bound_s(
        *kcounts.work(k, cfg, 1, 3000.0, 150000.0)) for k in ("symcon_fwd", "symcon_bwd"))
    got = read(record)
    assert got == pytest.approx(100.0 * bound / 0.016)
    assert 0 < got < 100
