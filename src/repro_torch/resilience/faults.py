"""Deterministic, env-armable fault injection: one mechanism for every drill.

A copy of the JAX package's ``resilience/faults.py`` (standard library
only), kept whole so that one ``REPRO_FAULT_PLAN`` arms both packages.  The
port consults every site at the same place as the JAX package: the
trainer's step loop and collation (``train.train_loop``), the checkpoint
commit (``train.checkpoint``), the heartbeat writer
(``resilience.heartbeat``) and the serving worker loop
(``serve.server.GraphServer``).

A *fault plan* is a JSON object mapping **site names** to spec dicts,
carried in the ``REPRO_FAULT_PLAN`` environment variable so child processes
spawned by ``launch.multihost.spawn_local`` (or a ``PodSupervisor``) can be
told to fail on purpose — the chaos half of the resilience subsystem.  The
registry of sites (see :data:`SITES`) and where each one is consulted:

``crash_at_step``
    Trainer step loop, *after* step ``spec["step"]`` completes (post
    heartbeat, pre checkpoint — the same boundary the legacy
    ``simulate_failure_at`` knob used).  ``mode="exit"`` (default)
    hard-kills the process with ``spec["exit_code"]`` (default
    :data:`EXIT_CRASH`); ``mode="raise"`` raises :class:`SimulatedCrash`
    so the normal teardown path runs (the old ad-hoc behaviour of
    ``tests/test_rescale.py``'s crash script).
``hang_at_step``
    ``Trainer._fetch_batch`` (host collate), when fetching while
    ``global_step == spec["step"]``: sleeps forever (or ``spec["hang_s"]``
    seconds) — the hung-host scenario a heartbeat watchdog must catch.
``slow_collate``
    ``Trainer._fetch_batch``, *every* call: sleeps ``spec["sleep_s"]`` —
    the slow-straggler scenario.
``corrupt_checkpoint_payload``
    ``train.checkpoint.save_checkpoint``, after the commit of step
    ``spec["step"]``: flips bytes in this process's committed payload file,
    so the restore-side checksum verification has something real to catch.
``drop_heartbeat``
    ``resilience.heartbeat.HeartbeatWriter.beat``: beats at
    ``step >= spec["step"]`` are silently not written — a process that
    looks hung to the supervisor while actually making progress.
``serve_worker_fault``
    ``serve.server.GraphServer`` worker loop: the first bin served after
    arming raises (same effect as ``inject_worker_fault``, but armable
    from the environment for chaos runs).

Every spec may carry ``"process": <int>`` to scope the fault to one
``process_index`` (default: fires on every process).  Step-keyed one-shot
sites match with **equality** on the step, so a supervised restart that
replays earlier steps does not re-fire a fault the supervisor stripped from
the relaunch environment — determinism is the point: a plan plus a process
identity fully determines when each fault fires.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Mapping, Optional

__all__ = [
    "ENV_FAULT_PLAN",
    "EXIT_CRASH",
    "SITES",
    "FaultPlan",
    "SimulatedCrash",
    "corrupt_file",
]

ENV_FAULT_PLAN = "REPRO_FAULT_PLAN"

#: exit code of a ``crash_at_step`` hard exit — distinct from generic
#: nonzero exits so a supervisor can tell an injected crash from a real one
EXIT_CRASH = 43

SITES = (
    "crash_at_step",
    "hang_at_step",
    "slow_collate",
    "corrupt_checkpoint_payload",
    "drop_heartbeat",
    "serve_worker_fault",
)


class SimulatedCrash(RuntimeError):
    """An injected ``crash_at_step`` fault in ``mode="raise"``."""


def corrupt_file(path: str, *, n_bytes: int = 64) -> int:
    """Flip ``n_bytes`` bytes in the middle of ``path`` in place.  Returns
    the number of bytes flipped (0 for an empty file)."""
    size = os.path.getsize(path)
    if size == 0:
        return 0
    n = min(n_bytes, size)
    off = max(0, size // 2 - n // 2)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())
    return n


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A parsed, validated fault plan (empty plan = no faults armed)."""

    specs: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    # ------------------------------ parsing -------------------------------

    @classmethod
    def parse(cls, spec: Any) -> "FaultPlan":
        """Build from a dict or a JSON string; loudly rejects unknown site
        names and non-dict specs (a typo'd chaos plan must never silently
        run fault-free)."""
        if spec is None or spec == "":
            return cls({})
        if isinstance(spec, str):
            try:
                spec = json.loads(spec)
            except ValueError as exc:
                raise ValueError(
                    f"{ENV_FAULT_PLAN} is not valid JSON: {exc}"
                ) from None
        if not isinstance(spec, Mapping):
            raise ValueError(
                f"fault plan must be a JSON object of site -> spec, "
                f"got {type(spec).__name__}"
            )
        specs: Dict[str, Dict[str, Any]] = {}
        for site, s in spec.items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; valid sites: "
                    f"{', '.join(SITES)}"
                )
            if not isinstance(s, Mapping):
                raise ValueError(
                    f"fault site {site!r} spec must be an object, "
                    f"got {type(s).__name__}"
                )
            specs[site] = dict(s)
        return cls(specs)

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "FaultPlan":
        env = os.environ if environ is None else environ
        return cls.parse(env.get(ENV_FAULT_PLAN, ""))

    def to_env(self) -> str:
        """The value to place in ``REPRO_FAULT_PLAN`` for a child process."""
        return json.dumps(self.specs, sort_keys=True)

    def __bool__(self) -> bool:
        return bool(self.specs)

    # ------------------------------ matching ------------------------------

    def _spec(
        self, site: str, *, process: Optional[int]
    ) -> Optional[Dict[str, Any]]:
        s = self.specs.get(site)
        if s is None:
            return None
        want = s.get("process")
        if want is not None and process is not None and int(want) != int(process):
            return None
        return s

    def _step_match(
        self, site: str, step: int, *, process: Optional[int]
    ) -> Optional[Dict[str, Any]]:
        s = self._spec(site, process=process)
        if s is None or int(s.get("step", -1)) != int(step):
            return None
        return s

    # ------------------------------- sites --------------------------------

    def crash_at_step(self, step: int, *, process: Optional[int] = None) -> None:
        """Consulted after step ``step`` completes.  Does not return when
        the fault fires."""
        s = self._step_match("crash_at_step", step, process=process)
        if s is None:
            return
        msg = (
            f"fault injection: crash_at_step fired at step {step}"
            + (f" on process {process}" if process is not None else "")
        )
        if s.get("mode", "exit") == "raise":
            raise SimulatedCrash(msg)
        print(msg, file=sys.stderr, flush=True)
        os._exit(int(s.get("exit_code", EXIT_CRASH)))

    def hang_at_step(self, step: int, *, process: Optional[int] = None) -> None:
        """Consulted from the host-collate path.  When it fires the process
        sleeps forever (or ``hang_s`` seconds) — simulating a wedged host
        whose peers stall in the next collective."""
        s = self._step_match("hang_at_step", step, process=process)
        if s is None:
            return
        print(
            f"fault injection: hang_at_step fired at step {step}",
            file=sys.stderr, flush=True,
        )
        hang_s = s.get("hang_s")
        if hang_s is not None:
            time.sleep(float(hang_s))
            return
        while True:  # pragma: no cover - killed externally
            time.sleep(60.0)

    def slow_collate(self, *, process: Optional[int] = None) -> float:
        """Consulted on every host collate; sleeps ``sleep_s`` and returns
        the injected delay (0.0 when not armed)."""
        s = self._spec("slow_collate", process=process)
        if s is None:
            return 0.0
        delay = float(s.get("sleep_s", 0.5))
        time.sleep(delay)
        return delay

    def corrupt_checkpoint_payload(
        self, step: int, *, process: Optional[int] = None
    ) -> bool:
        """True exactly when the just-committed checkpoint step matches the
        spec — the caller then corrupts its own payload file."""
        return self._step_match(
            "corrupt_checkpoint_payload", step, process=process
        ) is not None

    def drop_heartbeat(self, step: int, *, process: Optional[int] = None) -> bool:
        """True for every beat at ``step >= spec["step"]`` (persistent, not
        one-shot: a dropped heartbeat stream stays dropped)."""
        s = self._spec("drop_heartbeat", process=process)
        return s is not None and int(step) >= int(s.get("step", 0))

    def serve_worker_fault(self, *, worker: Optional[int] = None) -> bool:
        """True when the serving worker should raise on its next bin; scoped
        by ``spec["worker"]`` when given."""
        s = self.specs.get("serve_worker_fault")
        if s is None:
            return False
        want = s.get("worker")
        return want is None or worker is None or int(want) == int(worker)
