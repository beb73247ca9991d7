"""The port's tracer (``repro_torch.tracing``): when spans record, where the
trainer and the server put them, and that they share the clock of the
profiler's trace.

CPU tests at the sizes of tests/test_torch_train.py and
tests/test_torch_serve.py; the last test is marked ``gpu`` (a kernel's
device interval inside its span, the second-order twins' spans on
autograd's device thread) and skips without a card.  Imports no JAX.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.mace import MaceConfig, init_mace
from repro_torch.data.molecules import SyntheticCFMDataset
from repro_torch.serve import GraphServer, ServeConfig
from repro_torch.train.train_loop import Trainer, TrainerConfig

WIDTHS = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2,
              a_ls=(0, 1, 2), correlation=2, n_interactions=2,
              avg_num_neighbors=8.0, interaction_block_n=8)
TCFG = MaceConfig(**WIDTHS, impl="cuda", interaction_impl="cuda")
# the server's buckets block edges in the default tiles of 32 atoms
SCFG = dataclasses.replace(TCFG, interaction_block_n=32)
TRAIN = dict(capacity=48, edge_factor=16, max_graphs=8, block_n=8, block_e=32)
STEP_CHILDREN = {"train.wait", "train.h2d", "train.grads", "train.optimizer", "train.ema",
                 "train.sync"}
BIN_CHILDREN = {"serve.collate", "serve.copy_in", "serve.lock", "serve.replay",
                "serve.copy_out"}


@pytest.fixture(autouse=True)
def empty_buffer_and_one_thread():
    """Each test starts and ends with nothing recorded; its small CPU steps
    take one intra-op thread, as the suite runs several workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()
    torch.set_num_threads(threads)


def _trainer(device="cpu", prefetch=1):
    return Trainer(TCFG, TrainerConfig(**TRAIN, prefetch=prefetch),
                   SyntheticCFMDataset(24, seed=0, max_atoms=24), seed=0, device=device)


def _epoch_interval(sp, off):
    return tracing.to_epoch_ns(sp.t0, off), tracing.to_epoch_ns(sp.t1, off)


def _event_interval(prof, ev):
    base = tracing.trace_start_ns(prof)
    return (base + int(round(ev.time_range.start * 1e3)),
            base + int(round(ev.time_range.end * 1e3)))


def test_off_by_default_nothing_records():
    with tracing.span("outside") as sp:
        tracing.count("n", 3)
    assert sp is None
    assert tracing.start("outside") is None
    assert tracing.add("outside", 0.0, 1.0) is None
    tr = _trainer()
    tr.train(n_epochs=1, max_steps=1)
    assert tracing.spans() == []


def test_trainer_under_the_profiler_records_each_step_with_its_children():
    tr = _trainer()
    tr.train(n_epochs=1, max_steps=1)            # outside: records nothing
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train(n_epochs=1, max_steps=3)
    steps = tracing.spans("train.step")
    assert [s.id for s in steps] == [1, 2]
    by_uid = {s.uid: s for s in tracing.spans()}
    for s in steps:
        kids = {k.name for k in by_uid.values() if k.parent == s.uid}
        assert STEP_CHILDREN <= kids
        inside = [k for k in by_uid.values() if k.root == s.id and k is not s]
        assert {"model.tp_twin", "model.symcon_twin"} <= {k.name for k in inside}
        assert all(s.t0 <= k.t0 and k.t1 <= s.t1 for k in inside)
        assert s.counts["atoms"] > 0 and s.counts["edges"] > 0 and s.counts["graphs"] > 0
        # the blocked tp twin counts its slots; the step's edges are its valid ones
        tp_twins = [k for k in inside if k.name == "model.tp_twin"]
        assert all(k.counts["slots"] >= s.counts["edges"] for k in tp_twins)
    # the counters are the telemetry's real atoms, from the same host arrays
    assert [s.counts["atoms"] for s in steps] == [x[0] for x in tr.telemetry.loads[1:]]
    # the wait span is the pipeline's own reading
    waits = tracing.spans("train.wait")
    assert [w.seconds for w in waits] == pytest.approx(tr.telemetry.host_wait[1:], abs=1e-9)
    assert len(tr.telemetry.times) == 3 and all(t > 0 for (t,) in tr.telemetry.times)


def test_symmetric_contraction_spans_count_the_launched_rows_and_the_spec():
    """``model.symcon`` (each layer's forward contraction, on the step's
    thread) and ``model.symcon_twin`` (its second order) carry the atoms
    launched, padded to the kernels' 32-atom tiles, the channels, the
    largest l of B and of A, and the correlation."""
    tr = _trainer()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train(n_epochs=1, max_steps=2)
    step = tracing.spans("train.step")[-1]
    rows = -(-tr.bin_shape.max_nodes // 32) * 32
    want = {"rows": rows, "channels": 4, "hidden_lmax": 1, "a_lmax": 2, "correlation": 2}
    for name in ("model.symcon", "model.symcon_twin"):
        mine = [sp for sp in tracing.spans(name) if sp.root == step.id]
        assert len(mine) == TCFG.n_interactions, name
        assert all(sp.counts == want for sp in mine), [sp.counts for sp in mine]
    assert all(sp.parent is not None for sp in tracing.spans("model.symcon"))


def test_server_traces_the_requests_submitted_under_the_profiler():
    params = init_mace(SCFG, torch.Generator().manual_seed(0))
    ds = SyntheticCFMDataset(16, seed=3, max_atoms=24)
    with GraphServer(SCFG, params, ServeConfig(capacities=(24, 48), edge_factor=48,
                                               n_workers=1, max_wait_s=0.01),
                     device="cpu") as server:
        for f in [server.submit(ds.get(i)) for i in range(3)]:
            f.result(timeout=60)
        with profile(activities=[ProfilerActivity.CPU]):
            futures = [server.submit(ds.get(i)) for i in range(3, 6)]
            for f in futures:
                f.result(timeout=60)
        server.drain(timeout=60)
        stats = server.stats()
    assert "graphs_per_s" not in stats and "wall_s" not in stats
    requests = tracing.spans("serve.request")
    assert sorted(r.id for r in requests) == [3, 4, 5]
    queues = tracing.spans("serve.queue")
    assert sorted(q.root for q in queues) == [3, 4, 5]
    by_uid = {r.uid: r for r in requests}
    for q in queues:
        req = by_uid[q.parent]
        assert req.t0 == q.t0 <= q.t1 <= req.t1
    bins = tracing.spans("serve.bin")
    assert bins and sum(b.counts["graphs"] for b in bins) == 3
    assert sum(b.counts["atoms"] for b in bins) == sum(int(ds.sizes[i]) for i in range(3, 6))
    for b in bins:
        assert b.thread.startswith("serve-worker") and b.root in (3, 4, 5)
        assert 0 < b.counts["edges"] <= b.counts["edge_slots"]
        kids = {k.name for k in tracing.spans() if k.parent == b.uid}
        assert kids == BIN_CHILDREN
    assert tracing.spans("serve.pack")


def test_a_span_holds_its_aten_op_on_the_profiler_clock():
    x = torch.randn(300, 300)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x @ x
        with tracing.span("mm") as sp:
            x @ x
        x @ x
    off = tracing.epoch_offset_ns()
    a, b = _epoch_interval(sp, off)
    mms = [_event_interval(prof, e) for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == 3
    assert [a <= s and t <= b for s, t in mms] == [False, True, False]


def test_idle_gaps_name_a_planted_gap_by_its_innermost_span():
    x = torch.randn(200, 200)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("planted", id="here"):
                x @ x
                time.sleep(0.05)
        x @ x
    gaps = tracing.idle_gaps(prof, top=3)
    assert gaps[0]["span"] == "planted" and gaps[0]["id"] == "here"
    assert gaps[0]["s"] >= 0.045 and gaps[0]["before"] == "aten::matmul"
    assert gaps[0]["thread"] == threading.current_thread().name


def test_enable_records_everywhere_and_the_export_shares_the_clock(tmp_path):
    tracing.enable()
    seen = {}

    def other():
        with tracing.span("other", tracing.handed_off()) as sp:
            seen["sp"] = sp

    with tracing.span("cause", id=7) as cause, tracing.handoff(cause):
        tracing.count("n", 2)
        t = threading.Thread(target=other, name="helper")
        t.start()
        t.join()
    assert cause.counts == {"n": 2}
    assert seen["sp"].root == 7 and seen["sp"].parent == cause.uid
    assert seen["sp"].thread == "helper"
    assert tracing.handed_off() is None
    tracing.enable(False)
    assert tracing.start("off") is None

    path = tmp_path / "spans.json"
    assert tracing.export_chrome_trace(str(path)) == 2
    data = json.loads(path.read_text())
    ev = {e["name"]: e for e in data["traceEvents"] if e["ph"] == "X"}
    off = tracing.epoch_offset_ns()
    a, _ = _epoch_interval(cause, off)
    assert abs(data["baseTimeNanoseconds"] + ev["cause"]["ts"] * 1e3 - a) < 5e4
    assert ev["other"]["args"]["root"] == 7 and ev["cause"]["args"]["n"] == 2

    tracing.clear()
    x = torch.randn(100, 100)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("mm"):
            x @ x
    merged = tmp_path / "merged.json"
    assert tracing.export_chrome_trace(str(merged), prof) == 1
    data = json.loads(merged.read_text())
    span_ev = next(e for e in data["traceEvents"] if e.get("cat") == "span")
    mm = next(e for e in data["traceEvents"] if e.get("name") == "aten::mm")
    assert span_ev["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span_ev["ts"] + span_ev["dur"]


@pytest.mark.gpu
def test_on_the_card_kernels_lie_inside_their_spans_and_twins_run_on_autograds_thread():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flag = torch.autograd._profiler_enabled()
        with tracing.span("mm") as sp:
            x @ x
            torch.cuda.synchronize()
    assert flag and sp is not None
    a, b = _epoch_interval(sp, tracing.epoch_offset_ns())
    kernels = [_event_interval(prof, e) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels and all(a <= s and t <= b for s, t in kernels)

    tracing.clear()
    tr = _trainer(device=dev, prefetch=1)
    tr.train(n_epochs=1, max_steps=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        tr.train(n_epochs=1, max_steps=2)
        torch.cuda.synchronize()
    (step,) = tracing.spans("train.step")
    twins = tracing.spans("model.tp_twin", "model.symcon_twin")
    assert {t.name for t in twins} == {"model.tp_twin", "model.symcon_twin"}
    me = threading.current_thread().name
    assert all(t.thread != me and t.root == step.id == 1 for t in twins)
    assert all(step.t0 <= t.t0 and t.t1 <= step.t1 for t in twins)
    assert np.isfinite(tr.telemetry.times).all() and len(tr.telemetry.times) == 2
