"""Pod supervision: detect failure, classify it, drive elastic recovery.

Port of the JAX package's ``resilience/supervisor.py`` on the port's own
launcher (``repro_torch.launch.multihost``).  ``assess`` and the
``incidents.jsonl`` schema are the JAX module's.  The port runs one rank
per process, so the JAX ``SupervisorConfig.devices_per_proc`` (XLA CPU
devices forced into each child) has no counterpart: a pod's width is
``n_procs``.

:class:`PodSupervisor` owns a local pod (``launch.multihost.spawn_local``
children) and watches two signals: **child exit codes** and **heartbeat
staleness** (``heartbeat.read_heartbeats`` over a per-attempt directory it
hands each child via ``REPRO_HEARTBEAT_DIR``).  Incidents are classified —

``crash``
    a child exited nonzero (exit code :data:`~.faults.EXIT_CRASH` marks an
    injected crash; :data:`~.heartbeat.EXIT_HANG` a watchdog-converted hang,
    classified as ``hang``),
``hang``
    a live child whose newest beat is older than
    ``heartbeat_deadline_s`` (or that never beat within
    ``startup_grace_s``, or that outlived ``attempt_timeout_s``),
``slow_straggler``
    a live child whose step lags the pod max by more than
    ``slow_step_gap`` — *non-fatal*, logged once per process per attempt

— then the supervisor kills the stranded group, degrades the world size by
one (floored at ``min_procs``), sleeps an exponential backoff with
deterministic jitter, and relaunches.  The relaunched children find the
newest *committed* checkpoint themselves through the proven elastic restore
path (``Trainer.maybe_restore`` with ``elastic=True``); the supervisor only
restores the *pod*, never the tensors.  The restart budget is bounded:
exceeding ``max_restarts`` raises :class:`RestartBudgetExhausted` after a
``budget_exhausted`` incident naming the culprit.

Fault plans are armed **only on the first attempt** (unless
``rearm_faults=True``): ``REPRO_FAULT_PLAN`` is explicitly set to ``""``
for relaunches so a step-keyed fault does not re-fire after recovery.

Every observation lands in ``<run_dir>/incidents.jsonl`` — one JSON object
per line::

    {"t": <unix time>, "kind": "crash" | "hang" | "slow_straggler" |
     "relaunch" | "recovered" | "budget_exhausted" | "success",
     "attempt": <int>, "world_size": <int>,
     "process_index": <int | null>, "step": <int | null>,
     "exit_codes": [<int | null>, ...], "detail": "<human text>",
     "detection_s": <float | null>}

``detection_s`` on a crash/hang incident is the wall time between the
culprit's last published beat (or attempt start, if it never beat) and the
supervisor noticing; ``recovered`` records carry ``recovery_s`` (kill ->
first beat of the next attempt) and ``steps_lost`` (work re-done after the
restore, measured from the failed attempt's high-water step).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from ..launch.multihost import backoff_delays, spawn_local
from .faults import FaultPlan, ENV_FAULT_PLAN
from .heartbeat import ENV_HEARTBEAT_DIR, EXIT_HANG, read_heartbeats

__all__ = [
    "SupervisorConfig",
    "Incident",
    "PodSupervisor",
    "RestartBudgetExhausted",
    "assess",
]


class RestartBudgetExhausted(RuntimeError):
    """The pod kept failing past ``max_restarts`` relaunches."""


@dataclasses.dataclass
class SupervisorConfig:
    n_procs: int
    heartbeat_deadline_s: float = 60.0
    startup_grace_s: float = 180.0
    poll_s: float = 0.25
    max_restarts: int = 3
    backoff_base_s: float = 0.25
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    backoff_jitter: float = 0.25
    min_procs: int = 1
    slow_step_gap: int = 0          # 0 disables straggler reporting
    rearm_faults: bool = False      # keep REPRO_FAULT_PLAN armed on relaunch
    attempt_timeout_s: Optional[float] = None
    seed: int = 0


@dataclasses.dataclass
class Incident:
    kind: str
    process_index: Optional[int] = None
    step: Optional[int] = None
    detail: str = ""
    detection_s: Optional[float] = None
    fatal: bool = True


def assess(
    exit_codes: Sequence[Optional[int]],
    beats: Dict[int, Dict[str, Any]],
    *,
    now_wall: float,
    attempt_start_wall: float,
    heartbeat_deadline_s: float,
    startup_grace_s: float,
    slow_step_gap: int = 0,
) -> List[Incident]:
    """Classify the pod's current state into incidents (pure function of
    its inputs, so the decision table is unit-testable without processes).

    ``exit_codes[i]`` is child i's return code, or None while alive.
    ``beats`` is ``read_heartbeats`` output.  Fatal incidents (crash/hang)
    demand a relaunch; ``slow_straggler`` records are informational.
    """
    incidents: List[Incident] = []
    alive = [i for i, c in enumerate(exit_codes) if c is None]
    for i, code in enumerate(exit_codes):
        if code is None or code == 0:
            continue
        b = beats.get(i)
        last = b["t_wall"] if b else attempt_start_wall
        kind = "hang" if code == EXIT_HANG else "crash"
        detail = (
            f"process {i} exited {code}"
            + (" (watchdog-converted hang)" if code == EXIT_HANG else "")
            + (f" after step {b['step']}" if b else " before first beat")
        )
        incidents.append(Incident(
            kind=kind, process_index=i,
            step=b["step"] if b else None, detail=detail,
            detection_s=max(0.0, now_wall - last),
        ))
    for i in alive:
        b = beats.get(i)
        if b is None:
            age = now_wall - attempt_start_wall
            if age > startup_grace_s:
                incidents.append(Incident(
                    kind="hang", process_index=i, step=None,
                    detail=(
                        f"process {i} never published a heartbeat within "
                        f"the {startup_grace_s:.0f}s startup grace"
                    ),
                    detection_s=age,
                ))
            continue
        age = now_wall - b["t_wall"]
        if age > heartbeat_deadline_s:
            incidents.append(Incident(
                kind="hang", process_index=i, step=b["step"],
                detail=(
                    f"process {i} heartbeat stale for {age:.1f}s "
                    f"(> {heartbeat_deadline_s:.1f}s deadline) "
                    f"at step {b['step']}"
                ),
                detection_s=age,
            ))
    if slow_step_gap > 0 and beats:
        top = max(b["step"] for b in beats.values())
        for i in alive:
            b = beats.get(i)
            if b is not None and top - b["step"] > slow_step_gap:
                incidents.append(Incident(
                    kind="slow_straggler", process_index=i, step=b["step"],
                    detail=(
                        f"process {i} at step {b['step']} lags pod max "
                        f"{top} by more than {slow_step_gap}"
                    ),
                    fatal=False,
                ))
    return incidents


class PodSupervisor:
    """Launches, monitors, and elastically restarts a local pod.

    ``argv`` is the child command (same for every attempt — children read
    their world from the ``REPRO_*`` env vars ``spawn_local`` sets, so a
    degraded relaunch needs no argv surgery).
    """

    def __init__(
        self,
        argv: Sequence[str],
        cfg: SupervisorConfig,
        run_dir: str,
        *,
        fault_plan: Optional[FaultPlan] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        self.argv = list(argv)
        self.cfg = cfg
        self.run_dir = run_dir
        self.fault_plan = fault_plan if fault_plan is not None else FaultPlan({})
        self.base_env = dict(env or {})
        os.makedirs(run_dir, exist_ok=True)
        self.incidents_path = os.path.join(run_dir, "incidents.jsonl")
        self._backoff = backoff_delays(
            base=cfg.backoff_base_s, factor=cfg.backoff_factor,
            max_s=cfg.backoff_max_s, jitter=cfg.backoff_jitter, seed=cfg.seed,
        )

    # ----------------------------- logging --------------------------------

    def _record(
        self,
        kind: str,
        *,
        attempt: int,
        world_size: int,
        process_index: Optional[int] = None,
        step: Optional[int] = None,
        exit_codes: Sequence[Optional[int]] = (),
        detail: str = "",
        detection_s: Optional[float] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        rec = {
            "t": time.time(), "kind": kind, "attempt": attempt,
            "world_size": world_size, "process_index": process_index,
            "step": step, "exit_codes": list(exit_codes), "detail": detail,
            "detection_s": detection_s, **extra,
        }
        with open(self.incidents_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    # ------------------------------- run ----------------------------------

    def _attempt_env(self, attempt: int) -> Dict[str, str]:
        env = dict(self.base_env)
        env[ENV_HEARTBEAT_DIR] = os.path.join(
            self.run_dir, "hb", f"attempt{attempt}"
        )
        if attempt == 0 or self.cfg.rearm_faults:
            env[ENV_FAULT_PLAN] = self.fault_plan.to_env() if self.fault_plan else ""
        else:
            # spawn_local merges over os.environ, so an explicit "" is the
            # only way to strip a plan the parent itself was launched with.
            env[ENV_FAULT_PLAN] = ""
        return env

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        world = cfg.n_procs
        attempt = 0
        restarts = 0
        recoveries: List[Dict[str, Any]] = []
        pending_recovery: Optional[Dict[str, Any]] = None

        while True:
            hb_dir = os.path.join(self.run_dir, "hb", f"attempt{attempt}")
            os.makedirs(hb_dir, exist_ok=True)
            log_dir = os.path.join(self.run_dir, "logs", f"attempt{attempt}")
            if attempt > 0:
                self._record(
                    "relaunch", attempt=attempt, world_size=world,
                    detail=(
                        f"relaunching at world size {world} from newest "
                        f"committed checkpoint (restart {restarts}/"
                        f"{cfg.max_restarts})"
                    ),
                )
            res = spawn_local(
                world, self.argv,
                env=self._attempt_env(attempt), log_dir=log_dir,
            )
            attempt_start = time.time()
            kill_wall: Optional[float] = None
            fatal: List[Incident] = []
            straggler_seen: set = set()
            try:
                while True:
                    codes = [p.popen.poll() for p in res.procs]
                    beats = read_heartbeats(hb_dir)
                    now = time.time()
                    if pending_recovery is not None and beats:
                        first = min(beats.values(), key=lambda b: b["t_wall"])
                        rec = self._record(
                            "recovered", attempt=attempt, world_size=world,
                            process_index=first["process_index"],
                            step=first["step"], exit_codes=codes,
                            detail=(
                                f"attempt {attempt} produced its first beat "
                                f"at step {first['step']}"
                            ),
                            recovery_s=now - pending_recovery["kill_wall"],
                            steps_lost=max(
                                0,
                                pending_recovery["last_step"]
                                - (first["step"] - 1),
                            ),
                            first_beat_step=first["step"],
                        )
                        recoveries.append(rec)
                        pending_recovery = None
                    if all(c == 0 for c in codes):
                        self._record(
                            "success", attempt=attempt, world_size=world,
                            exit_codes=codes,
                            detail=f"pod completed after {restarts} restarts",
                        )
                        return {
                            "ok": True, "attempts": attempt + 1,
                            "restarts": restarts, "world_size_final": world,
                            "incidents_path": self.incidents_path,
                            "recoveries": recoveries,
                        }
                    incidents = assess(
                        codes, beats,
                        now_wall=now, attempt_start_wall=attempt_start,
                        heartbeat_deadline_s=cfg.heartbeat_deadline_s,
                        startup_grace_s=cfg.startup_grace_s,
                        slow_step_gap=cfg.slow_step_gap,
                    )
                    if (
                        cfg.attempt_timeout_s is not None
                        and now - attempt_start > cfg.attempt_timeout_s
                        and not any(i.fatal for i in incidents)
                    ):
                        incidents.append(Incident(
                            kind="hang",
                            detail=(
                                f"attempt {attempt} exceeded the "
                                f"{cfg.attempt_timeout_s:.0f}s attempt "
                                f"timeout"
                            ),
                            detection_s=now - attempt_start,
                        ))
                    for inc in incidents:
                        if not inc.fatal:
                            if inc.process_index not in straggler_seen:
                                straggler_seen.add(inc.process_index)
                                self._record(
                                    inc.kind, attempt=attempt,
                                    world_size=world,
                                    process_index=inc.process_index,
                                    step=inc.step, exit_codes=codes,
                                    detail=inc.detail,
                                    detection_s=inc.detection_s,
                                )
                            continue
                        fatal.append(inc)
                        self._record(
                            inc.kind, attempt=attempt, world_size=world,
                            process_index=inc.process_index, step=inc.step,
                            exit_codes=codes, detail=inc.detail,
                            detection_s=inc.detection_s,
                        )
                    if fatal:
                        break
                    time.sleep(cfg.poll_s)
            finally:
                if fatal or any(
                    p.popen.poll() is None for p in res.procs
                ):
                    if fatal:
                        res.kill()
                        kill_wall = time.time()
                    else:
                        res.kill()  # unwind (exception path): leave no orphans

            # ---- fatal incident: degrade, back off, relaunch -------------
            beats = read_heartbeats(hb_dir)
            last_step = max(
                (b["step"] for b in beats.values()), default=0
            )
            restarts += 1
            if restarts > cfg.max_restarts:
                culprit = fatal[0]
                self._record(
                    "budget_exhausted", attempt=attempt, world_size=world,
                    process_index=culprit.process_index, step=culprit.step,
                    detail=(
                        f"restart budget ({cfg.max_restarts}) exhausted; "
                        f"last incident: {culprit.detail}"
                    ),
                )
                raise RestartBudgetExhausted(
                    f"pod failed {restarts} times (budget "
                    f"{cfg.max_restarts}); last incident: {culprit.detail}; "
                    f"see {self.incidents_path}"
                )
            pending_recovery = {
                "kill_wall": kill_wall if kill_wall is not None else time.time(),
                "last_step": last_step,
            }
            world = max(cfg.min_procs, world - 1)
            time.sleep(next(self._backoff))
            attempt += 1
