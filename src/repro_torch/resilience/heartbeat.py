"""Per-step heartbeats and an in-process step watchdog.

A copy of the JAX package's ``resilience/heartbeat.py`` (standard library
only), so that a supervisor of either package reads the other's beats.

Each training process writes a monotonic heartbeat file
``heartbeat.<process_index>.json`` into a shared run directory after every
optimizer step — atomically (tmp + ``os.replace``), so a reader never sees
a torn write.  A :class:`PodSupervisor` polls these files: a process whose
newest beat is older than the configured deadline is *hung* even though its
OS process is still alive (the classic stalled-collective failure mode).

The heartbeat record schema (one JSON object per file, overwritten each
beat)::

    {"process_index": 1, "step": 42, "epoch": 3,
     "t_wall": 1754650000.123, "seq": 43, "pid": 31337}

``seq`` increments on every *attempted* beat, including beats suppressed by
an armed ``drop_heartbeat`` fault — ``step``/``t_wall`` only advance when
the beat is actually written.

:class:`StepWatchdog` is the in-process half: the trainer arms it with the
current step before blocking work (collate, collective step) and disarms it
after.  If a step exceeds the deadline, the watchdog's monitor thread fires
``on_deadline`` — by default logging loudly and hard-exiting with
:data:`EXIT_HANG` so the hang converts into a supervisor-visible process
death instead of an indefinite pod stall.  Pass ``on_deadline`` to override
(tests use a recording callback), or call :meth:`StepWatchdog.check` from
the driving thread to get a synchronous :class:`StepDeadlineExceeded`.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

from .faults import FaultPlan

__all__ = [
    "ENV_HEARTBEAT_DIR",
    "EXIT_HANG",
    "HeartbeatWriter",
    "read_heartbeats",
    "StepDeadlineExceeded",
    "StepWatchdog",
]

ENV_HEARTBEAT_DIR = "REPRO_HEARTBEAT_DIR"

#: exit code when the in-process watchdog converts a hang into a crash
EXIT_HANG = 44


class HeartbeatWriter:
    """Atomically publishes this process's per-step progress.

    ``plan`` (a :class:`FaultPlan`) lets the ``drop_heartbeat`` chaos site
    suppress writes while the process keeps training.
    """

    def __init__(
        self,
        run_dir: str,
        process_index: int = 0,
        *,
        plan: Optional[FaultPlan] = None,
    ):
        self.run_dir = run_dir
        self.process_index = int(process_index)
        self.plan = plan if plan is not None else FaultPlan({})
        self.seq = 0
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(
            run_dir, f"heartbeat.{self.process_index}.json"
        )

    def beat(self, step: int, epoch: int = 0) -> bool:
        """Record progress; returns False when suppressed by fault plan."""
        self.seq += 1
        if self.plan.drop_heartbeat(step, process=self.process_index):
            return False
        rec = {
            "process_index": self.process_index,
            "step": int(step),
            "epoch": int(epoch),
            "t_wall": time.time(),
            "seq": self.seq,
            "pid": os.getpid(),
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return True


def read_heartbeats(run_dir: str) -> Dict[int, Dict[str, Any]]:
    """All readable heartbeat records in ``run_dir``, keyed by
    process_index.  Tolerates missing dirs and torn/corrupt files (a
    monitor must never die on a racing writer)."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("heartbeat.") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(run_dir, name)) as f:
                rec = json.load(f)
            out[int(rec["process_index"])] = rec
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


class StepDeadlineExceeded(RuntimeError):
    """A training step exceeded the watchdog deadline."""


def _default_on_deadline(step: int, elapsed: float, deadline: float) -> None:
    print(
        f"StepWatchdog: step {step} exceeded deadline "
        f"({elapsed:.1f}s > {deadline:.1f}s); exiting {EXIT_HANG} so the "
        f"supervisor sees a crash instead of a stalled collective",
        file=sys.stderr, flush=True,
    )
    os._exit(EXIT_HANG)


class StepWatchdog:
    """Bounds the wall time of each armed step.

    Usage::

        wd = StepWatchdog(deadline_s=30.0)
        wd.arm(step)
        ... blocking collate / engine.step ...
        wd.disarm()

    A lazy daemon monitor thread wakes every ``poll_s`` and, when an armed
    step has been running longer than ``deadline_s``, records the expiry
    and invokes ``on_deadline(step, elapsed, deadline)`` once.  The
    default handler hard-exits with :data:`EXIT_HANG`.  The driving thread
    can also call :meth:`check` to raise :class:`StepDeadlineExceeded`
    synchronously (useful when ``on_deadline`` is a no-op recorder).
    """

    def __init__(
        self,
        deadline_s: float,
        *,
        poll_s: float = 0.1,
        on_deadline: Optional[Callable[[int, float, float], None]] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s)
        self.on_deadline = on_deadline or _default_on_deadline
        self.expired: Optional[Dict[str, float]] = None
        self._lock = threading.Lock()
        self._armed_step: Optional[int] = None
        self._armed_at = 0.0
        self._fired_for: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, name="step-watchdog", daemon=True
            )
            self._thread.start()

    def arm(self, step: int) -> None:
        with self._lock:
            self._armed_step = int(step)
            self._armed_at = time.monotonic()
        self._ensure_thread()

    def disarm(self) -> None:
        with self._lock:
            self._armed_step = None

    def observe(self, step: int):
        """Context manager: ``with wd.observe(step): engine.step(...)``."""
        return _Observed(self, step)

    def check(self) -> None:
        """Raise :class:`StepDeadlineExceeded` if a deadline has expired."""
        exp = self.expired
        if exp is not None:
            raise StepDeadlineExceeded(
                f"step {int(exp['step'])} exceeded deadline "
                f"({exp['elapsed']:.1f}s > {self.deadline_s:.1f}s)"
            )

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                step, armed_at = self._armed_step, self._armed_at
            if step is None or self._fired_for == step:
                continue
            elapsed = time.monotonic() - armed_at
            if elapsed <= self.deadline_s:
                continue
            self._fired_for = step
            self.expired = {"step": float(step), "elapsed": elapsed}
            try:
                self.on_deadline(step, elapsed, self.deadline_s)
            except Exception:  # a broken handler must not kill the monitor
                pass


class _Observed:
    def __init__(self, wd: StepWatchdog, step: int):
        self.wd, self.step = wd, step

    def __enter__(self):
        self.wd.arm(self.step)
        return self.wd

    def __exit__(self, *exc):
        self.wd.disarm()
        return False
