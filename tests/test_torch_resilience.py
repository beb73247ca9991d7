"""Port parity, resilience: the counterparts of the quick tier of
tests/test_resilience.py, on the CPU.

* ``resilience/heartbeat.py`` is the JAX module, statement for statement
  (the docstring aside): heartbeat round trip, tolerance of torn files,
  the ``drop_heartbeat`` site, a watchdog that fires once and refuses a
  deadline of 0 or less.
* ``assess`` gives the JAX ``assess``'s incidents on every case of the
  decision table; ``backoff_delays`` is the JAX sequence.
* The ``corrupt_checkpoint_payload`` site: the restore falls back past the
  corrupt step, in one process and in a trainer.
* The supervisor drills as 2-process pods, over a small child without
  torch (as the JAX quick tier) and over 2 gloo ranks of
  ``launch.train``: a crash recovers to a degraded success with the plan
  stripped, a hang is detected by heartbeat staleness, an exhausted budget
  names the process and the incidents path.  The supervisor's config is
  the JAX one without ``devices_per_proc`` (one rank per process).
* ``launch.train --supervised --device cpu --reduced`` end to end: a crash
  of process 1 after step 2 recovers at world size 1 and the final
  checkpoint is step 4, written by one process at one rank.

Every supervised pod runs under a deadline; the trainers' process groups
have a collective timeout (``launch.train``'s).
"""
import ast
import dataclasses
import inspect
import itertools
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.resilience.heartbeat as jheartbeat
from repro.launch.multihost import backoff_delays as jbackoff
from repro.resilience.supervisor import SupervisorConfig as JSupervisorConfig
from repro.resilience.supervisor import assess as jassess
from repro_torch.launch.multihost import backoff_delays
import repro_torch.resilience.heartbeat as theartbeat
from repro_torch.resilience import (
    ENV_FAULT_PLAN,
    EXIT_CRASH,
    EXIT_HANG,
    FaultPlan,
    HeartbeatWriter,
    PodSupervisor,
    RestartBudgetExhausted,
    StepDeadlineExceeded,
    StepWatchdog,
    SupervisorConfig,
    assess,
    read_heartbeats,
)
from repro_torch.train import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 240

# every incidents.jsonl record carries this envelope (the JAX schema)
INCIDENT_KEYS = {"t", "kind", "attempt", "world_size", "process_index", "step",
                 "exit_codes", "detail", "detection_s"}
INCIDENT_KINDS = {"crash", "hang", "slow_straggler", "relaunch", "recovered",
                  "budget_exhausted", "success"}


def _body(module):
    tree = ast.parse(inspect.getsource(module))
    tree.body = tree.body[1:]  # the module docstring
    return ast.dump(tree)


def test_heartbeat_module_is_the_reference_module():
    assert _body(theartbeat) == _body(jheartbeat)
    assert (theartbeat.ENV_HEARTBEAT_DIR, theartbeat.EXIT_HANG) == (
        jheartbeat.ENV_HEARTBEAT_DIR, jheartbeat.EXIT_HANG) == ("REPRO_HEARTBEAT_DIR", 44)


# ---------------------------------------------------------------------------
# heartbeats and the watchdog
# ---------------------------------------------------------------------------


def test_heartbeat_write_read_round_trip(tmp_path):
    HeartbeatWriter(str(tmp_path), 1).beat(3, epoch=2)
    HeartbeatWriter(str(tmp_path), 0).beat(4)
    beats = read_heartbeats(str(tmp_path))
    assert set(beats) == {0, 1}
    assert beats[1]["step"] == 3 and beats[1]["epoch"] == 2
    assert beats[1]["seq"] == 1 and beats[1]["pid"] == os.getpid()
    assert beats[0]["step"] == 4
    # the JAX reader reads the port's files
    assert jheartbeat.read_heartbeats(str(tmp_path)) == beats
    assert sorted(p.name for p in tmp_path.iterdir()) == ["heartbeat.0.json",
                                                         "heartbeat.1.json"]


def test_read_heartbeats_tolerates_missing_dir_and_torn_files(tmp_path):
    assert read_heartbeats(str(tmp_path / "missing")) == {}
    (tmp_path / "heartbeat.0.json").write_text("{torn")
    (tmp_path / "heartbeat.1.json").write_text("{}")  # no process_index
    (tmp_path / "unrelated.txt").write_text("hi")
    assert read_heartbeats(str(tmp_path)) == {}


def test_drop_heartbeat_site_suppresses_writes_but_counts_them(tmp_path):
    plan = FaultPlan.parse({"drop_heartbeat": {"step": 2, "process": 0}})
    hb = HeartbeatWriter(str(tmp_path), 0, plan=plan)
    assert hb.beat(1) and not hb.beat(2) and not hb.beat(3)
    assert hb.seq == 3
    assert read_heartbeats(str(tmp_path))[0]["step"] == 1
    other = HeartbeatWriter(str(tmp_path), 1, plan=plan)  # scoped to process 0
    assert other.beat(5) and read_heartbeats(str(tmp_path))[1]["step"] == 5


def test_watchdog_fires_once_and_check_raises():
    fired = []
    wd = StepWatchdog(0.15, poll_s=0.02, on_deadline=lambda s, e, d: fired.append((s, e, d)))
    try:
        wd.arm(7)
        t_end = time.monotonic() + 5.0
        while not fired and time.monotonic() < t_end:
            time.sleep(0.02)
        assert fired, "watchdog never fired"
        step, elapsed, deadline = fired[0]
        assert step == 7 and elapsed > 0.15 and deadline == 0.15
        with pytest.raises(StepDeadlineExceeded, match="step 7"):
            wd.check()
        time.sleep(0.1)
        assert len(fired) == 1
        with wd.observe(8):
            pass  # a fast step never fires
        time.sleep(0.2)
        assert len(fired) == 1
    finally:
        wd.close()


@pytest.mark.parametrize("deadline", [0.0, -1.0])
def test_watchdog_refuses_a_deadline_of_zero_or_less(deadline):
    with pytest.raises(ValueError, match="deadline_s"):
        StepWatchdog(deadline)


# ---------------------------------------------------------------------------
# the decision table and the backoff
# ---------------------------------------------------------------------------


def _beat(i, step, t_wall):
    return {"process_index": i, "step": step, "epoch": 0, "t_wall": t_wall,
            "seq": step, "pid": 1}


NOW = 1000.0
# (exit codes, beats, attempt start before now, heartbeat deadline, grace, gap)
ASSESS_CASES = {
    "crash": ([EXIT_CRASH, None], {0: _beat(0, 5, NOW - 1), 1: _beat(1, 5, NOW)},
              10, 30, 60, 0),
    "other_exit_code": ([None, 1], {0: _beat(0, 2, NOW)}, 10, 30, 60, 0),
    "watchdog_hang_before_first_beat": ([EXIT_HANG], {}, 2, 30, 60, 0),
    "watchdog_hang_after_a_beat": ([None, EXIT_HANG], {1: _beat(1, 3, NOW - 4)},
                                   20, 30, 60, 0),
    "clean": ([0, None], {1: _beat(1, 3, NOW)}, 5, 30, 60, 0),
    "all_done": ([0, 0], {0: _beat(0, 9, NOW), 1: _beat(1, 9, NOW)}, 5, 30, 60, 0),
    "stale": ([None, None], {0: _beat(0, 4, NOW - 45), 1: _beat(1, 4, NOW - 1)},
              100, 30, 60, 0),
    "within_grace": ([None], {}, 30, 5, 60, 0),
    "past_grace": ([None], {}, 90, 5, 60, 0),
    "straggler": ([None, None], {0: _beat(0, 9, NOW), 1: _beat(1, 3, NOW)}, 50, 30, 60, 4),
    "straggler_off": ([None, None], {0: _beat(0, 9, NOW), 1: _beat(1, 3, NOW)},
                      50, 30, 60, 0),
    "crash_and_stale_and_straggler": (
        [None, 2, None], {0: _beat(0, 12, NOW - 50), 1: _beat(1, 7, NOW - 3),
                          2: _beat(2, 2, NOW)}, 200, 30, 60, 5),
}


@pytest.mark.parametrize("case", sorted(ASSESS_CASES))
def test_assess_matches_the_jax_decision(case):
    codes, beats, start, deadline, grace, gap = ASSESS_CASES[case]
    kw = dict(now_wall=NOW, attempt_start_wall=NOW - start, heartbeat_deadline_s=deadline,
              startup_grace_s=grace, slow_step_gap=gap)
    got = [dataclasses.asdict(i) for i in assess(codes, beats, **kw)]
    want = [dataclasses.asdict(i) for i in jassess(codes, beats, **kw)]
    assert got == want
    if case == "crash":
        assert got[0]["kind"] == "crash" and "exited 43" in got[0]["detail"]
    if case.startswith("watchdog"):
        assert got[0]["kind"] == "hang" and "watchdog-converted" in got[0]["detail"]
    if case in ("clean", "all_done", "within_grace", "straggler_off"):
        assert got == []


def test_backoff_delays_match_the_jax_sequence():
    kw = dict(base=0.1, factor=2.0, max_s=1.0, jitter=0.25)
    a = list(itertools.islice(backoff_delays(seed=7, **kw), 8))
    assert a == list(itertools.islice(jbackoff(seed=7, **kw), 8))
    assert a != list(itertools.islice(backoff_delays(seed=8, **kw), 8))
    for i, d in enumerate(a):
        nominal = min(0.1 * 2.0 ** i, 1.0)
        assert 0.75 * nominal - 1e-9 <= d <= 1.25 * nominal + 1e-9, (i, d)
    assert list(itertools.islice(backoff_delays(base=0.1, factor=2.0, max_s=1.0,
                                                jitter=0.0), 6)) == pytest.approx(
        [0.1, 0.2, 0.4, 0.8, 1.0, 1.0])


# ---------------------------------------------------------------------------
# the corrupt_checkpoint_payload site
# ---------------------------------------------------------------------------


def _state(v):
    return {"w": torch.full((4, 3), v), "b": torch.arange(3, dtype=torch.float32) + v}


def test_corrupt_checkpoint_payload_site_and_restore_fallback(tmp_path, monkeypatch, capfd):
    monkeypatch.setenv(ENV_FAULT_PLAN, json.dumps({"corrupt_checkpoint_payload": {"step": 4}}))
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 2, _state(2.0))
    ckpt.save_checkpoint(d, 4, _state(4.0))
    assert "corrupt_checkpoint_payload flipped" in capfd.readouterr().err
    # the commit succeeded; the payload was poisoned after it
    assert ckpt.latest_step(d) == 4
    assert ckpt.verify_payload(d, 2) is None and ckpt.verify_payload(d, 4) is not None
    with pytest.warns(RuntimeWarning, match="corrupt"):
        step, state, _ = ckpt.restore_checkpoint(d, _state(0.0))
    assert step == 2 and torch.equal(state["w"], _state(2.0)["w"])
    # scoped to another process: nothing fires
    monkeypatch.setenv(ENV_FAULT_PLAN, json.dumps(
        {"corrupt_checkpoint_payload": {"step": 6, "process": 1}}))
    ckpt.save_checkpoint(d, 6, _state(6.0))
    assert ckpt.verify_payload(d, 6) is None


def test_trainer_restore_falls_back_past_the_corrupt_step(tmp_path, monkeypatch):
    from repro_torch.core.mace import MaceConfig
    from repro_torch.data.molecules import SyntheticCFMDataset
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    widths = dict(n_species=10, channels=4, hidden_ls=(0, 1), sh_lmax=2, a_ls=(0, 1, 2),
                  correlation=2, n_interactions=2, avg_num_neighbors=8.0,
                  interaction_block_n=8)

    def trainer():
        tcfg = TrainerConfig(capacity=48, edge_factor=16, max_graphs=8, block_n=8,
                             block_e=32, ckpt_dir=str(tmp_path), ckpt_every=1)
        return Trainer(MaceConfig(**widths, impl="cuda", interaction_impl="cuda"), tcfg,
                       SyntheticCFMDataset(16, seed=0, max_atoms=24), seed=0, device="cpu")

    monkeypatch.setenv(ENV_FAULT_PLAN, json.dumps({"corrupt_checkpoint_payload": {"step": 2}}))
    trainer().train(n_epochs=1, max_steps=2)
    monkeypatch.delenv(ENV_FAULT_PLAN)
    resumed = trainer()
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert resumed.maybe_restore()
    assert resumed.global_step == 1 and resumed.sampler_state.cursor == 1


# ---------------------------------------------------------------------------
# PodSupervisor drills over a small child without torch
# ---------------------------------------------------------------------------

# a stand-in trainer: beats once per "step" and consults the step loop's
# fault sites; the supervisor's detect -> kill -> degrade -> relaunch ->
# recover cycle runs in seconds
DRILL_CHILD = textwrap.dedent("""\
    import os, sys, time
    sys.path.insert(0, sys.argv[1])
    from repro_torch.resilience.faults import FaultPlan
    from repro_torch.resilience.heartbeat import ENV_HEARTBEAT_DIR, HeartbeatWriter

    proc = int(os.environ["REPRO_PROCESS_ID"])
    plan = FaultPlan.from_env()
    hb = HeartbeatWriter(os.environ[ENV_HEARTBEAT_DIR], proc, plan=plan)
    for step in range(1, 7):
        time.sleep(0.05)
        hb.beat(step)
        plan.crash_at_step(step, process=proc)
        plan.hang_at_step(step, process=proc)
    print(f"proc {proc} done", flush=True)
""")


def _drill_supervisor(tmp_path, plan, **overrides):
    child = tmp_path / "child.py"
    child.write_text(DRILL_CHILD)
    kw = dict(n_procs=2, heartbeat_deadline_s=2.0, startup_grace_s=30.0, poll_s=0.05,
              max_restarts=2, backoff_base_s=0.05, backoff_max_s=0.1, seed=0,
              attempt_timeout_s=60.0)
    kw.update(overrides)
    return PodSupervisor([sys.executable, str(child), str(REPO / "src")],
                         SupervisorConfig(**kw), str(tmp_path / "run"),
                         fault_plan=FaultPlan.parse(plan),
                         env={"PYTHONPATH": str(REPO / "src")})


def _incidents(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for r in recs:
        assert INCIDENT_KEYS <= set(r), r
        assert r["kind"] in INCIDENT_KINDS, r
    return recs


def test_supervisor_recovers_from_an_injected_crash_with_the_plan_stripped(tmp_path):
    # crash on process 0: the relaunch runs only process 0, so a plan that
    # was not stripped would crash it again
    sup = _drill_supervisor(tmp_path, {"crash_at_step": {"step": 3, "process": 0}})
    summary = sup.run()
    assert summary["ok"] and summary["restarts"] == 1 and summary["attempts"] == 2
    assert summary["world_size_final"] == 1
    recs = _incidents(sup.incidents_path)
    assert [r["kind"] for r in recs] == ["crash", "relaunch", "recovered", "success"]
    crash, relaunch, recovered, _ = recs
    assert crash["process_index"] == 0 and crash["step"] == 3
    assert crash["exit_codes"][0] == EXIT_CRASH and "exited 43" in crash["detail"]
    assert crash["detection_s"] is not None and crash["detection_s"] < 10.0
    assert relaunch["world_size"] == 1 and "checkpoint" in relaunch["detail"]
    assert recovered["recovery_s"] > 0.0 and 0 <= recovered["steps_lost"] <= 6
    assert summary["recoveries"] == [recovered]
    assert sup._attempt_env(1)[ENV_FAULT_PLAN] == ""
    assert json.loads(sup._attempt_env(0)[ENV_FAULT_PLAN]) == {
        "crash_at_step": {"step": 3, "process": 0}}


def test_supervisor_detects_a_hang_by_heartbeat_staleness(tmp_path):
    sup = _drill_supervisor(tmp_path, {"hang_at_step": {"step": 2, "process": 1}})
    t0 = time.monotonic()
    summary = sup.run()
    assert summary["ok"] and summary["restarts"] == 1 and summary["world_size_final"] == 1
    hangs = [r for r in _incidents(sup.incidents_path) if r["kind"] == "hang"]
    assert hangs and hangs[0]["process_index"] == 1 and hangs[0]["step"] == 2
    assert "stale" in hangs[0]["detail"] and hangs[0]["detection_s"] >= 2.0
    assert time.monotonic() - t0 < 30.0


def test_supervisor_budget_exhaustion_names_the_process_and_the_log(tmp_path):
    sup = _drill_supervisor(tmp_path, {"crash_at_step": {"step": 2, "process": 0}},
                            max_restarts=1, min_procs=2, rearm_faults=True)
    with pytest.raises(RestartBudgetExhausted) as ei:
        sup.run()
    msg = str(ei.value)
    assert "budget" in msg and "process 0" in msg and "incidents.jsonl" in msg
    recs = _incidents(sup.incidents_path)
    kinds = [r["kind"] for r in recs]
    assert kinds[-1] == "budget_exhausted" and recs[-1]["process_index"] == 0
    assert kinds.count("crash") == 2 and kinds.count("relaunch") == 1
    assert "success" not in kinds


def test_supervisor_config_is_the_jax_config_without_devices_per_proc():
    """One rank per process: the port's fields and defaults are the JAX
    ones but for ``devices_per_proc`` (XLA CPU devices forced per child)."""
    want = {f.name: f.default for f in dataclasses.fields(JSupervisorConfig)
            if f.name != "devices_per_proc"}
    assert {f.name: f.default for f in dataclasses.fields(SupervisorConfig)} == want


# ---------------------------------------------------------------------------
# PodSupervisor drills over 2 gloo ranks of launch.train
# ---------------------------------------------------------------------------


def _gloo_pod(tmp_path, plan, **overrides):
    """A supervisor over ``launch.train --distributed --elastic`` children
    on the CPU (the reduced config, a checkpoint every step)."""
    child = [sys.executable, "-m", "repro_torch.launch.train", "--distributed", "--elastic",
             "--device", "cpu", "--reduced", "--steps", "4", "--ckpt-every", "1",
             "--ckpt-dir", str(tmp_path / "ckpt")]
    kw = dict(n_procs=2, startup_grace_s=120.0, poll_s=0.1, max_restarts=2,
              backoff_base_s=0.05, backoff_max_s=0.1, seed=0, attempt_timeout_s=180.0)
    kw.update(overrides)
    return PodSupervisor(child, SupervisorConfig(**kw), str(tmp_path / "run"),
                         fault_plan=FaultPlan.parse(plan),
                         env={"PYTHONPATH": str(REPO / "src")})


def test_gloo_pod_hang_is_detected_by_heartbeat_staleness(tmp_path):
    # no step watchdog: the hung rank and its peer, blocked in the next
    # all-reduce, stop beating; the relaunch restores step 2 at world 1
    sup = _gloo_pod(tmp_path, {"hang_at_step": {"step": 2, "process": 0}},
                    heartbeat_deadline_s=4.0)
    summary = sup.run()
    assert summary["ok"] and summary["restarts"] == 1 and summary["world_size_final"] == 1
    recs = _incidents(sup.incidents_path)
    hangs = [r for r in recs if r["attempt"] == 0]
    assert hangs and {r["kind"] for r in hangs} == {"hang"}
    assert all("stale" in r["detail"] and r["detection_s"] >= 4.0 for r in hangs)
    assert 0 in {r["process_index"] for r in hangs} and hangs[0]["step"] == 2
    assert [r["kind"] for r in recs[len(hangs):]] == ["relaunch", "recovered", "success"]
    step, meta = ckpt.read_meta(str(tmp_path / "ckpt"))
    assert (step, meta["n_ranks"], meta["process_count"]) == (4, 1, 1)


def test_gloo_pod_budget_exhaustion_names_the_process_and_the_log(tmp_path):
    sup = _gloo_pod(tmp_path, {"crash_at_step": {"step": 1, "process": 1}},
                    heartbeat_deadline_s=60.0, max_restarts=1, min_procs=2,
                    rearm_faults=True)
    with pytest.raises(RestartBudgetExhausted) as ei:
        sup.run()
    msg = str(ei.value)
    assert "process 1 exited 43" in msg and "incidents.jsonl" in msg
    kinds = [r["kind"] for r in _incidents(sup.incidents_path)]
    assert kinds.count("relaunch") == 1 and kinds[-1] == "budget_exhausted"
    assert kinds.count("crash") >= 2 and "success" not in kinds


# ---------------------------------------------------------------------------
# the supervised entry point
# ---------------------------------------------------------------------------


def test_supervised_launch_train_recovers_a_crash_at_world_size_one(tmp_path):
    run = tmp_path / "run"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--distributed",
           "--supervised", "--nprocs", "2", "--device", "cpu", "--reduced",
           "--steps", "4", "--ckpt-every", "1", "--ckpt-dir", str(run),
           "--heartbeat-deadline-s", "120"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_FAULT_PLAN=json.dumps({"crash_at_step": {"step": 2, "process": 1}}))
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S)
    logs = "".join(p.read_text()[-2000:] for p in sorted(run.glob("supervisor/logs/*/*.log")))
    assert proc.returncode == 0, proc.stdout + proc.stderr + logs
    assert "supervised pod done: attempts=2 restarts=1 final world=1" in proc.stdout
    recs = _incidents(run / "supervisor" / "incidents.jsonl")
    assert [r["kind"] for r in recs] == ["crash", "relaunch", "recovered", "success"]
    assert recs[0]["process_index"] == 1 and recs[0]["exit_codes"][1] == EXIT_CRASH
    assert recs[1]["world_size"] == 1
    step, meta = ckpt.read_meta(str(run))
    assert step == 4 and meta["n_ranks"] == 1 and meta["process_count"] == 1
    assert meta["lineage"] == [{"n_ranks": 2, "cursor": 1}]
    # the relaunch restored step 1 of the 2-process run (it died after step
    # 2, before its checkpoint) and took steps 2-4
    relaunched = (run / "supervisor" / "logs" / "attempt1" / "proc0.log").read_text()
    assert "resumed at step 1" in relaunched and "done: 3 steps" in relaunched
    assert not np.isnan(float(relaunched.split("final loss ")[1].split(",")[0]))
