"""Multi-process bring-up on ``torch.distributed``: process-group init and a
local subprocess launcher.

Port of the JAX package's ``launch/multihost.py``.

``initialize_distributed``
    Wraps ``dist.init_process_group`` with explicit
    coordinator/num_processes/process_id plumbing (arguments or the
    ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
    env vars), a pre-flight reachability probe of the coordinator, and a
    RuntimeError naming what to set, not a hang, when configuration is
    missing or the coordinator cannot be reached.  The backend is a
    required argument: ``nccl`` when every rank has a card of its own,
    ``gloo`` on the CPU and when several ranks share one card (NCCL refuses
    two ranks on one device).  :func:`choose_backend` makes that choice up
    front for a caller to print; nothing here swaps a backend that failed
    for another.

``spawn_local``
    Runs N copies of a command on this machine as one process group.
    Process 0's coordinator port is picked free at spawn time and handed to
    every child through the env vars above, so the spawned program only
    needs to call ``initialize_distributed()``.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.multihost --nprocs 2 -- \\
        python -m repro_torch.launch.train --distributed --device cpu \\
        --reduced --steps 5
"""
from __future__ import annotations

import datetime
import os
import random
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
BACKENDS = ("gloo", "nccl")

_HELP = (
    "multi-process bring-up needs a coordinator address and a process "
    "identity. Provide them via flags (--coordinator HOST:PORT "
    "--num-processes N --process-id I) or env vars "
    f"({ENV_COORDINATOR}, {ENV_NUM_PROCESSES}, {ENV_PROCESS_ID}). "
    "For a single-machine rehearsal use "
    "`python -m repro_torch.launch.multihost --nprocs N -- <cmd...>`, which "
    "sets all three for every child."
)


def pick_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backoff_delays(
    base: float = 0.05,
    factor: float = 2.0,
    max_s: float = 2.0,
    jitter: float = 0.25,
    seed: Optional[int] = None,
) -> Iterator[float]:
    """Infinite exponential-backoff delay sequence with multiplicative
    jitter: ``base * factor**k``, capped at ``max_s``, each scaled by a
    uniform factor in ``[1-jitter, 1+jitter]``.  A ``seed`` makes the
    sequence deterministic."""
    rng = random.Random(seed)
    delay = base
    while True:
        scale = 1.0 + jitter * (2.0 * rng.random() - 1.0) if jitter else 1.0
        yield min(delay, max_s) * scale
        delay = min(delay * factor, max_s)


def coordinator_reachable(
    coordinator: str, timeout: float = 2.0, *, backoff_seed: Optional[int] = None
) -> bool:
    """TCP-probe the coordinator, so a typo'd address fails in seconds with
    a clear message instead of hanging in the rendezvous.  Retries with
    exponential backoff + jitter until ``timeout``: process 0 may still be
    importing torch when its peers first probe."""
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        return False
    deadline = time.monotonic() + timeout
    delays = backoff_delays(
        base=0.05, factor=2.0, max_s=1.0, jitter=0.25, seed=backoff_seed
    )
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return False
        try:
            with socket.create_connection((host, int(port)), timeout=max(left, 0.1)):
                return True
        except OSError:
            time.sleep(min(next(delays), max(left, 0.0)))


def choose_backend(device: str, num_processes: int) -> str:
    """``gloo`` for CPU ranks and for ranks that share a card, ``nccl``
    when each of ``num_processes`` ranks has a card of its own."""
    import torch

    if str(device).startswith("cuda") and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    probe_timeout: float = 30.0,
    timeout_s: float = 300.0,
) -> None:
    """``dist.init_process_group`` with explicit config and clear errors.

    Falls back to the REPRO_* env vars for any argument not given.
    ``coordinator`` is ``HOST:PORT`` (process 0 hosts the rendezvous store
    there; the others probe it first) or an init-method URL such as
    ``file:///path`` (no probe).  Every collective of the group fails
    after ``timeout_s`` instead of waiting forever.  Raises RuntimeError
    (not a hang) when config is missing, the coordinator is unreachable,
    or ``nccl`` is asked for without a CUDA card.
    """
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])

    if coordinator is None or num_processes is None or process_id is None:
        missing = [
            name
            for name, val in [
                ("coordinator", coordinator),
                ("num-processes", num_processes),
                ("process-id", process_id),
            ]
            if val is None
        ]
        raise RuntimeError(f"missing {', '.join(missing)}: {_HELP}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")

    import torch
    import torch.distributed as dist

    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend 'nccl' needs a CUDA card and none is visible; use "
            "'gloo' for CPU ranks"
        )
    if "://" in coordinator:
        init_method = coordinator
    else:
        # process 0 hosts the store, so only the others probe it
        if process_id != 0 and not coordinator_reachable(coordinator, probe_timeout):
            raise RuntimeError(
                f"coordinator {coordinator!r} is unreachable from process "
                f"{process_id} (TCP connect failed within {probe_timeout}s). "
                "Check that process 0 is up, the address/port match on every "
                f"host, and no firewall blocks it. {_HELP}"
            )
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )


@dataclass
class LocalProc:
    """One spawned child of ``spawn_local``."""

    process_id: int
    popen: subprocess.Popen
    log_path: Optional[str] = None


@dataclass
class SpawnResult:
    procs: List[LocalProc] = field(default_factory=list)
    coordinator: str = ""

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Wait for all children; returns per-process return codes.
        Kills the whole group if any child exceeds ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        codes: List[Optional[int]] = [None] * len(self.procs)
        try:
            for p in self.procs:
                left = None if deadline is None else max(0.1, deadline - time.monotonic())
                codes[p.process_id] = p.popen.wait(timeout=left)
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        return [c if c is not None else -1 for c in codes]

    def kill(self) -> None:
        for p in self.procs:
            if p.popen.poll() is None:
                p.popen.kill()
        for p in self.procs:
            try:
                p.popen.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def spawn_local(
    n_procs: int,
    argv: Sequence[str],
    *,
    env: Optional[Dict[str, str]] = None,
    log_dir: Optional[str] = None,
) -> SpawnResult:
    """Spawn ``argv`` N times on this machine as one process group.

    Each child gets REPRO_COORDINATOR/NUM_PROCESSES/PROCESS_ID, and
    ``OMP_NUM_THREADS=1`` unless the caller's environment sets it (as
    ``torchrun`` does: N processes of one thread per core each oversubscribe
    the cores, which made CPU steps 20 times slower).  With
    ``log_dir`` set, child i's stdout+stderr stream to
    ``{log_dir}/proc{i}.log``; otherwise output is inherited.
    """
    if n_procs < 1:
        raise ValueError("n_procs must be >= 1")
    coordinator = f"127.0.0.1:{pick_free_port()}"
    result = SpawnResult(coordinator=coordinator)
    for i in range(n_procs):
        child_env = dict(os.environ)
        if env:
            child_env.update(env)
        child_env[ENV_COORDINATOR] = coordinator
        child_env[ENV_NUM_PROCESSES] = str(n_procs)
        child_env[ENV_PROCESS_ID] = str(i)
        child_env.setdefault("OMP_NUM_THREADS", "1")
        log_path = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            log_path = os.path.join(log_dir, f"proc{i}.log")
            out = open(log_path, "wb")
        else:
            out = None
        popen = subprocess.Popen(
            list(argv), env=child_env,
            stdout=out, stderr=subprocess.STDOUT if out else None,
        )
        if out is not None:
            out.close()  # child keeps its own fd
        result.procs.append(LocalProc(i, popen, log_path))
        if i == 0:
            # Give the coordinator a moment to bind before peers probe it.
            time.sleep(0.2)
    return result


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="run N local processes as one torch.distributed group"
    )
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given; usage: ... --nprocs 2 -- python -m ...")
    res = spawn_local(args.nprocs, cmd, log_dir=args.log_dir)
    print(f"spawned {args.nprocs} procs, coordinator {res.coordinator}")
    codes = res.wait(timeout=args.timeout)
    for i, c in enumerate(codes):
        print(f"proc {i}: exit {c}")
    sys.exit(max(abs(c) for c in codes))


if __name__ == "__main__":
    main()
