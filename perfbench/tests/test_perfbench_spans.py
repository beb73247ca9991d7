"""The readers of the port's spans: each computes its number from planted
spans and gives None when nothing was traced; a CPU run at the small size
of test_perfbench_run.py records nothing with ``--trace 0`` and reports
every one of them with ``--trace 1``."""
from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_run import SERVE, TINY_TRAFFIC, TRAIN, drive
from repro_torch import tracing

TRAIN_READERS = {"twin_ms.train": 300.0, "optimizer_ms.train": 40.0,
                 "sync_wait_ms.train": 250.0}
SERVE_READERS = {"queue_ms.serve": 200.0, "prep_ms.serve": 3.0, "edge_fill.serve": 20.0}


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


def plant_steps():
    """Two steps: twins 0.1 + 0.2 s, optimizer 0.03 + EMA 0.01 s and a
    sync of 0.25 s in each."""
    for i in range(2):
        t = 10.0 * i
        st = tracing.start("train.step", id=i, t0=t)
        for name, s in (("model.tp_twin", 0.1), ("model.symcon_twin", 0.2),
                        ("train.optimizer", 0.03), ("train.ema", 0.01), ("train.sync", 0.25)):
            tracing.add(name, t, t + s, st)
        st.end(t + 1.0)


def plant_requests():
    """Two requests queued 0.1 and 0.3 s; two bins of 30 and 10 real edges
    in 100 slots each, collated in 2 ms and copied in 1 ms."""
    for i, q in enumerate((0.1, 0.3)):
        req = tracing.start("serve.request", id=i, t0=0.0)
        tracing.add("serve.queue", 0.0, q, req)
        b = tracing.start("serve.bin", req, t0=q, bucket="n64")
        b.count("edges", (30, 10)[i])
        b.count("edge_slots", 100)
        tracing.add("serve.collate", q, q + 0.002, b)
        tracing.add("serve.copy_in", q + 0.002, q + 0.003, b)
        b.end(q + 0.01)
        req.end(q + 0.01)


@pytest.mark.parametrize("name", sorted({**TRAIN_READERS, **SERVE_READERS}))
def test_a_reader_computes_its_number_from_planted_spans(name):
    tracing.enable()
    plant_steps() if name in TRAIN_READERS else plant_requests()
    tracing.enable(False)
    want = {**TRAIN_READERS, **SERVE_READERS}[name]
    assert harness.module("metrics", name).read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted({**TRAIN_READERS, **SERVE_READERS}))
def test_a_reader_gives_none_when_nothing_was_traced(name):
    assert harness.module("metrics", name).read({}) is None


def test_an_untraced_run_records_no_span(capsys, monkeypatch):
    line = drive(SERVE, capsys, monkeypatch, trace=0)
    assert line["correct"] and tracing.spans() == []


@pytest.mark.parametrize("cell,names", [(TRAIN, TRAIN_READERS), (SERVE, SERVE_READERS)])
def test_a_traced_run_reports_every_span_reader(cell, names, capsys, monkeypatch):
    if cell == SERVE:
        # serving traces the requests its clients send during the stretch,
        # each after a result lands: seconds of it see some on a busy CPU
        monkeypatch.setitem(TINY_TRAFFIC, "profile_s", 3.0)
    line = drive(cell, capsys, monkeypatch, trace=1)
    assert line["correct"]
    got = {k: line["metrics"][k]["value"] for k in names}
    assert all(v > 0 for v in got.values()), got
