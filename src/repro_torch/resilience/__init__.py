"""Fault-tolerant pod supervision: chaos injection, heartbeats, restart.

The port's copy of the JAX package's ``resilience`` (the same fault plans,
heartbeat files and incident records, so that either package's tools read
the other's), on the port's launcher and trainer.

The paper's 740-GPU training runs live or die by whole-pod health — one
crashed or hung host stalls every collective.  This package closes the loop
between the repo's recovery primitives (atomic barrier'd checkpoints,
elastic world-size restore) and the failures that need them, in three
layers:

:mod:`~repro_torch.resilience.faults` — deterministic chaos injection
    A JSON *fault plan* in the ``REPRO_FAULT_PLAN`` env var arms named
    injection sites threaded through the stack.  The registry:

    ==============================  ========================================
    site                            fires in
    ==============================  ========================================
    ``crash_at_step``               trainer step loop, after step N (exit
                                    code 43, or ``mode="raise"``)
    ``hang_at_step``                host collate at step N (sleep forever)
    ``slow_collate``                host collate, every call (straggler)
    ``corrupt_checkpoint_payload``  checkpoint save, flips committed bytes
    ``drop_heartbeat``              heartbeat writer, beats at step >= N
    ``serve_worker_fault``          graph-server worker loop
    ==============================  ========================================

    Specs may scope to one ``process_index``; step-keyed sites match by
    equality so a recovered run replaying earlier steps cannot re-fire.

:mod:`~repro_torch.resilience.heartbeat` — liveness signal + in-process watchdog
    Every training process atomically publishes ``heartbeat.<i>.json``
    (process_index, step, epoch, t_wall, seq, pid) into a shared run
    directory after each optimizer step.  ``StepWatchdog`` bounds the wall
    time of each armed step; on expiry it raises ``StepDeadlineExceeded``
    (or, by default, exits 44) so a hung peer becomes a loud, attributable
    failure instead of an indefinite collective stall.

:mod:`~repro_torch.resilience.supervisor` — detection, classification, recovery
    ``PodSupervisor`` launches the pod via ``launch.multihost.spawn_local``
    and watches child exit codes plus heartbeat staleness.  Incidents are
    classified crash / hang / slow_straggler, the stranded group is
    killed, and the pod relaunches at degraded world size (elastic restore
    finds the newest committed checkpoint); restarts are budget-bounded
    with exponential backoff + deterministic jitter.  Every event appends
    one JSON line to ``<run_dir>/incidents.jsonl``::

        {"t", "kind", "attempt", "world_size", "process_index", "step",
         "exit_codes", "detail", "detection_s"}

    with ``kind`` one of ``crash | hang | slow_straggler | relaunch |
    recovered | budget_exhausted | success`` (``recovered`` rows add
    ``recovery_s``, ``steps_lost``, ``first_beat_step``).

Residual (see ROADMAP): this supervises *local* pods; real multi-machine
supervision needs a per-host agent.  Every collective of a child's process
group already fails after ``initialize_distributed(timeout_s=...)``.
"""
from .faults import (
    ENV_FAULT_PLAN,
    EXIT_CRASH,
    SITES,
    FaultPlan,
    SimulatedCrash,
    corrupt_file,
)
from .heartbeat import (
    ENV_HEARTBEAT_DIR,
    EXIT_HANG,
    HeartbeatWriter,
    StepDeadlineExceeded,
    StepWatchdog,
    read_heartbeats,
)
from .supervisor import (
    Incident,
    PodSupervisor,
    RestartBudgetExhausted,
    SupervisorConfig,
    assess,
)

__all__ = [
    "ENV_FAULT_PLAN",
    "ENV_HEARTBEAT_DIR",
    "EXIT_CRASH",
    "EXIT_HANG",
    "SITES",
    "FaultPlan",
    "SimulatedCrash",
    "corrupt_file",
    "HeartbeatWriter",
    "read_heartbeats",
    "StepDeadlineExceeded",
    "StepWatchdog",
    "Incident",
    "PodSupervisor",
    "RestartBudgetExhausted",
    "SupervisorConfig",
    "assess",
]
