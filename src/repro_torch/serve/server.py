"""Continuous-batching graph server: queue -> Algorithm-1 packer -> workers.

Port of the JAX package's ``serve/server.py`` onto the torch
:class:`~repro_torch.serve.engine.ServeEngine`, which serves each bucket by
replaying one CUDA graph over static buffers.  The server runs on the CUDA
card unless built with ``device="cpu"``; without a card it raises.

Threading layout (all daemon threads, owned by :class:`GraphServer`):

* ``submit()`` puts requests on a **bounded** ``queue.Queue`` — backpressure
  is the queue filling up (``ServerSaturated`` on timeout), never unbounded
  memory;
* one **batcher** thread gathers request waves (up to ``max_wait_s`` linger
  or ``max_wave`` requests), packs them with Algorithm 1 onto the bucket
  ladder (``serve.buckets``), and enqueues :class:`PackedBin` work items;
* ``n_workers`` **worker** threads pull packed bins, collate to the bucket
  shape (host-side edge blocking included when the kernel consumes it), run
  the bucket's forward, and route per-graph energies/forces back to
  each request's ``Future``.  Collation is numpy and the kernels run
  asynchronously on the card, so workers overlap host and device work.
  The workers share the engine, whose buckets each own one set of static
  buffers and outputs: a lock per bucket covers the copy in, the replay and
  the copy of energies and forces to the host;
* an optional **watchdog** thread runs :meth:`GraphServer.healthcheck` and
  triggers :meth:`drain_and_rebuild` when a worker has died.

Fault story: a worker that raises marks itself dead and *requeues* its
in-flight bin first (bounded by ``max_bin_retries`` — then the futures fail
with the underlying error instead of hanging).  ``drain_and_rebuild``
stops the surviving workers at a bin boundary, re-queues anything still in
flight, closes the engine, builds a fresh warm engine
(``make_serve_engine``) and restarts a full fleet — zero requests dropped
(tests/test_torch_serve.py kills a worker mid-load and proves it).  The
rebuild takes every bucket lock before it closes the old engine, so no
worker is inside a replay when its graph is released.  A worker that
outlived the join may still run host work and copies on its own stream
while the new engine captures; capture runs in ``thread_local`` error mode
(``serve.engine``), so that cannot invalidate it, and the worker's next
forward reaches either the closed engine, which raises (its bin is
requeued), or the new one, under the bucket's lock.

``REPRO_FAULT_PLAN`` (``resilience.faults``) arms the same drill from the
environment: with a ``serve_worker_fault`` spec, the first bin a worker
takes after startup raises.

An ``"auto"`` impl resolves from the tuning table before the ladder is
built (``engine.resolve_serve_config`` at the largest bucket); the
interaction decision's tile geometry becomes every bucket's, and the
decisions are kept in ``GraphServer.autotune_decisions`` and reported by
``stats()``.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.mace import MaceConfig
from repro_torch.data.collate import BinShape
from repro_torch.data.molecules import Molecule
from repro_torch.kernels import autotune
from repro_torch.resilience.faults import FaultPlan

from .buckets import (
    RequestTooLarge,
    bucket_key,
    bucket_ladder,
    pack_requests,
)
from .engine import ServeEngine, make_serve_engine, resolve_device, resolve_serve_config

__all__ = [
    "ServeConfig",
    "ServeResult",
    "GraphServer",
    "ServerClosed",
    "ServerSaturated",
    "RequestTimeout",
    "RequestTooLarge",
]

log = logging.getLogger(__name__)

_POLL_S = 0.02  # worker/batcher queue poll period (stop-flag re-check)


class ServerClosed(RuntimeError):
    """submit() after close()."""


class ServerSaturated(RuntimeError):
    """The bounded request queue stayed full past the submit timeout."""


class RequestTimeout(RuntimeError):
    """A request's per-request deadline (``submit(timeout_s=...)``) expired
    before a worker produced its result — the future fails instead of
    waiting forever on a wedged fleet, and the slot it held is reclaimed
    (expired requests are dropped from waves before packing and skipped at
    result routing)."""


@dataclasses.dataclass
class ServeConfig:
    """Queue/bucket/fleet knobs.  Defaults are CPU-demo sized."""

    capacities: Tuple[int, ...] = (64, 256)  # bucket ladder (atoms per bin)
    edge_factor: int = 48                    # max_edges = capacity * this
    max_graphs: Optional[int] = None         # per-bucket graph slots (None: capacity//8)
    block_n: int = 32                        # blocking tile geometry (all buckets)
    block_e: int = 128
    queue_depth: int = 1024                  # bounded request queue
    n_workers: int = 2
    max_wait_s: float = 0.02                 # batching window before a partial wave packs
    max_wave: int = 256                      # pack at most this many requests at once
    watchdog_s: float = 0.0                  # healthcheck period (0 = no watchdog thread)
    max_bin_retries: int = 2                 # re-serves of a bin whose worker died


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome routed back through the future."""

    energy: float          # total potential energy of the graph
    forces: np.ndarray     # [n_atoms, 3]
    latency_s: float       # submit -> result wall seconds
    bucket: str            # bucket_key of the shape that served it
    worker: int            # worker id that ran the forward
    n_copacked: int        # graphs sharing the bin (batching evidence)


@dataclasses.dataclass
class _Request:
    req_id: int
    mol: Molecule
    future: Future
    t_submit: float
    deadline: Optional[float] = None   # perf_counter domain (t_submit + timeout_s)


@dataclasses.dataclass
class _PackedBin:
    requests: List[_Request]
    bucket: BinShape
    retries: int = 0


class _Stop:
    pass


_STOP = _Stop()


@dataclasses.dataclass
class _Worker:
    wid: int
    thread: Optional[threading.Thread] = None
    served_bins: int = 0
    served_graphs: int = 0
    busy_s: float = 0.0
    last_beat: float = 0.0
    error: Optional[BaseException] = None

    @property
    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


class GraphServer:
    """Continuous-batching MACE inference service (see module docstring).

    Use as a context manager; ``submit(mol)`` returns a ``Future`` that
    resolves to a :class:`ServeResult`.
    """

    def __init__(
        self,
        mace_cfg: MaceConfig,
        params: Any,
        cfg: ServeConfig = ServeConfig(),
        *,
        start: bool = True,
        device: Optional[Any] = None,
    ):
        # None -> the CUDA card; raises before any thread starts if absent
        self.device = resolve_device(device)
        # resolve "auto" impls BEFORE the ladder is built, so that a tuning
        # decision's tile geometry flows into every bucket's blocking
        # (mirror of Trainer.__init__)
        mace_cfg, self.autotune_decisions = resolve_serve_config(
            mace_cfg, capacity=max(cfg.capacities), edge_factor=cfg.edge_factor,
            platform=autotune.platform_of(self.device),
        )
        d = self.autotune_decisions.get("interaction")
        if d is not None and d.block_n is not None:
            cfg = dataclasses.replace(cfg, block_n=int(d.block_n), block_e=int(d.block_e))
        self.mace_cfg = mace_cfg
        self.cfg = cfg
        self.buckets = bucket_ladder(
            cfg.capacities, edge_factor=cfg.edge_factor,
            max_graphs=cfg.max_graphs, block_n=cfg.block_n,
            block_e=cfg.block_e,
        )
        self._params = params
        self.engine: ServeEngine = make_serve_engine(
            mace_cfg, params, self.buckets, device=self.device
        )

        self._requests: "queue.Queue" = queue.Queue(maxsize=cfg.queue_depth)
        self._bins: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._closed = False
        self._lock = threading.Lock()          # stats + fleet bookkeeping
        self._rebuild_lock = threading.Lock()  # one drain-and-rebuild at a time
        self._req_ids = itertools.count()
        self._wids = itertools.count()
        self._inflight: Dict[int, _PackedBin] = {}
        self._fault_inject: set = set()        # worker ids to fail (tests/drills)
        self._timed: Dict[int, _Request] = {}  # requests with a deadline
        # one lock per bucket around the shared engine's static buffers and
        # outputs (copy in, replay, copy to the host)
        self._bucket_locks = {bucket_key(b): threading.Lock() for b in self.buckets}
        # env-armable chaos (REPRO_FAULT_PLAN serve_worker_fault): the
        # first bin served after startup raises, same path as
        # inject_worker_fault but drivable from outside the process
        self._env_fault_pending = FaultPlan.from_env().serve_worker_fault()

        # telemetry
        self._latencies: List[float] = []
        self._bucket_bins: Dict[str, int] = {}
        self._bucket_graphs: Dict[str, int] = {}
        self._n_submitted = 0
        self._n_served = 0
        self._n_failed = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_result: Optional[float] = None
        self.rebuild_events: List[Dict[str, Any]] = []

        self.workers: List[_Worker] = []
        self._batcher: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------ lifecycle ------------------------------

    def start(self) -> None:
        if self._batcher is not None:
            return
        self._batcher = threading.Thread(
            target=self._batcher_loop, name="serve-batcher", daemon=True
        )
        self._batcher.start()
        self._spawn_workers(self.cfg.n_workers)
        if self.cfg.watchdog_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="serve-watchdog", daemon=True
            )
            self._watchdog.start()

    def _spawn_workers(self, n: int) -> None:
        for _ in range(n):
            w = _Worker(wid=next(self._wids))
            w.thread = threading.Thread(
                target=self._worker_loop, args=(w,),
                name=f"serve-worker-{w.wid}", daemon=True,
            )
            w.last_beat = time.monotonic()
            with self._lock:
                self.workers.append(w)
            w.thread.start()

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the service.  ``drain=True`` (default) first serves every
        already-submitted request; ``drain=False`` cancels pending futures.
        Idempotent."""
        self._closed = True  # reject new submits immediately
        if drain:
            self.drain(timeout=timeout)
        self._stop.set()
        for t in [self._batcher, self._watchdog] + [
            w.thread for w in self.workers
        ]:
            if t is not None and t.is_alive():
                t.join(timeout=5.0)
        self._batcher = self._watchdog = None
        if not drain:
            self._cancel_pending()
        self._close_engine()

    def _close_engine(self) -> None:
        """Close the engine holding every bucket lock, so that no worker
        (one that outlived its join included) is inside a replay of a graph
        that the close releases."""
        for lock in self._bucket_locks.values():
            lock.acquire()
        try:
            self.engine.close()
        finally:
            for lock in self._bucket_locks.values():
                lock.release()

    def _cancel_pending(self) -> None:
        for q in (self._requests, self._bins):
            try:
                while True:
                    item = q.get_nowait()
                    reqs = (
                        item.requests if isinstance(item, _PackedBin)
                        else [item] if isinstance(item, _Request) else []
                    )
                    for r in reqs:
                        r.future.cancel()
            except queue.Empty:
                pass

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted request has resolved (or timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                done = self._n_served + self._n_failed >= self._n_submitted
            if done and self._requests.empty() and self._bins.empty():
                return True
            time.sleep(_POLL_S)
        return False

    def __enter__(self) -> "GraphServer":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close(drain=exc_info[0] is None)

    # ------------------------------- client --------------------------------

    def submit(
        self,
        mol: Molecule,
        *,
        timeout: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> Future:
        """Enqueue one graph; returns a future of :class:`ServeResult`.

        Raises :class:`RequestTooLarge` immediately when no bucket can hold
        the graph even alone, and :class:`ServerSaturated` when the bounded
        queue stays full past ``timeout`` (backpressure, not buffering).

        ``timeout_s`` is a per-*request* deadline: if no worker has resolved
        the future within ``timeout_s`` of submission, it fails with
        :class:`RequestTimeout` (swept by the batcher thread each poll) and
        its slot is reclaimed — instead of the caller blocking forever when
        the fleet is wedged."""
        if self._closed:
            raise ServerClosed("server is closed")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        largest = self.buckets[-1]
        if mol.n_atoms > largest.max_nodes or mol.n_edges > largest.max_edges:
            raise RequestTooLarge(
                f"graph of {mol.n_atoms} atoms / {mol.n_edges} edges exceeds "
                f"the largest bucket {bucket_key(largest)}"
            )
        fut: Future = Future()
        now = time.perf_counter()
        req = _Request(
            next(self._req_ids), mol, fut, now,
            deadline=None if timeout_s is None else now + timeout_s,
        )
        try:
            self._requests.put(req, timeout=timeout)
        except queue.Full:
            raise ServerSaturated(
                f"request queue full ({self.cfg.queue_depth}) past "
                f"timeout={timeout}s"
            ) from None
        with self._lock:
            self._n_submitted += 1
            if req.deadline is not None:
                self._timed[req.req_id] = req
            if self._t_first_submit is None:
                self._t_first_submit = time.perf_counter()
        return fut

    def submit_many(
        self,
        mols: Sequence[Molecule],
        *,
        timeout: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> List[Future]:
        return [self.submit(m, timeout=timeout, timeout_s=timeout_s) for m in mols]

    # ------------------------------- batcher -------------------------------

    def _sweep_timeouts(self) -> int:
        """Expire deadline'd requests whose time is up: fail their futures
        with :class:`RequestTimeout`.  Runs on the batcher thread each poll,
        so requests expire whether they sit in the request queue, a packed
        bin, or a wedged worker's in-flight bin.  Returns the number
        expired."""
        now = time.perf_counter()
        with self._lock:
            done = [
                rid for rid, r in self._timed.items() if r.future.done()
            ]
            for rid in done:
                del self._timed[rid]
            expired = [
                r for r in self._timed.values() if now > r.deadline
            ]
            for r in expired:
                del self._timed[r.req_id]
        n = 0
        for r in expired:
            try:
                r.future.set_exception(RequestTimeout(
                    f"request {r.req_id} ({r.mol.n_atoms} atoms) unserved "
                    f"after {now - r.t_submit:.2f}s "
                    f"(timeout_s={r.deadline - r.t_submit:.2f})"
                ))
                n += 1
            except InvalidStateError:
                pass  # a worker resolved it in the race window — it won
        if n:
            with self._lock:
                self._n_failed += n
            log.warning("serve: %d request(s) timed out", n)
        return n

    def _batcher_loop(self) -> None:
        """Gather waves of requests and pack them onto the bucket ladder."""
        while not self._stop.is_set():
            self._sweep_timeouts()
            try:
                first = self._requests.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            wave = [first]
            deadline = time.monotonic() + self.cfg.max_wait_s
            # continuous batching: linger briefly so co-arriving requests
            # share bins, but never past the window (latency bound)
            while len(wave) < self.cfg.max_wave:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    wave.append(self._requests.get(timeout=left))
                except queue.Empty:
                    break
            self._pack_wave(wave)

    def _pack_wave(self, wave: List[_Request]) -> None:
        # reclaim slots of requests that already expired (RequestTimeout)
        # or were cancelled: they must not consume pack or forward work
        wave = [r for r in wave if not r.future.done()]
        if not wave:
            return
        sizes = [r.mol.n_atoms for r in wave]
        edges = [r.mol.n_edges for r in wave]
        try:
            packed = pack_requests(sizes, edges, self.buckets)
        except BaseException as exc:
            # a packing failure must fail the wave's futures, never kill
            # the batcher thread silently (clients would hang forever)
            for r in wave:
                if not r.future.done():
                    r.future.set_exception(exc)
            with self._lock:
                self._n_failed += len(wave)
            log.warning("serve batcher failed a wave of %d: %r", len(wave), exc)
            return
        for idxs, bucket in packed:
            self._bins.put(
                _PackedBin([wave[i] for i in idxs], bucket)
            )

    # ------------------------------- workers -------------------------------

    def _worker_loop(self, w: _Worker) -> None:
        while not self._stop.is_set():
            w.last_beat = time.monotonic()
            try:
                item = self._bins.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            if isinstance(item, _Stop):
                return
            with self._lock:
                self._inflight[w.wid] = item
            try:
                if w.wid in self._fault_inject:
                    self._fault_inject.discard(w.wid)
                    raise RuntimeError(
                        f"injected fault in worker {w.wid}"
                    )
                with self._lock:  # exactly one worker takes the fault
                    fire, self._env_fault_pending = self._env_fault_pending, False
                if fire:
                    raise RuntimeError(
                        f"injected fault (REPRO_FAULT_PLAN "
                        f"serve_worker_fault) in worker {w.wid}"
                    )
                self._serve_bin(w, item)
                with self._lock:
                    self._inflight.pop(w.wid, None)
            except BaseException as exc:  # worker dies; bin survives
                w.error = exc
                with self._lock:
                    pending = self._inflight.pop(w.wid, None)
                if pending is not None:
                    self._requeue(pending, exc)
                log.warning("serve worker %d died: %r", w.wid, exc)
                return

    def _requeue(self, pbin: _PackedBin, exc: BaseException) -> None:
        """A dead worker's bin goes back on the queue — up to the retry
        budget, after which its futures fail with the underlying error
        (never a silent drop, never a hang)."""
        if pbin.retries < self.cfg.max_bin_retries:
            pbin.retries += 1
            self._bins.put(pbin)
        else:
            for r in pbin.requests:
                if not r.future.done():
                    r.future.set_exception(exc)
            with self._lock:
                self._n_failed += len(pbin.requests)

    def _serve_bin(self, w: _Worker, pbin: _PackedBin) -> None:
        t0 = time.perf_counter()
        mols = [r.mol for r in pbin.requests]
        engine = self.engine
        batch, _ = engine.collate(mols, pbin.bucket)
        key = bucket_key(pbin.bucket)
        with self._bucket_locks[key]:
            energy, forces = engine.forward(batch, pbin.bucket)
            energy = energy.cpu().numpy()
            forces = forces.cpu().numpy()
        t_done = time.perf_counter()
        n_off = 0
        delivered: List[_Request] = []
        for g, r in enumerate(pbin.requests):
            n = r.mol.n_atoms
            res = ServeResult(
                energy=float(energy[g]),
                forces=forces[n_off : n_off + n].copy(),
                latency_s=t_done - r.t_submit,
                bucket=key,
                worker=w.wid,
                n_copacked=len(pbin.requests),
            )
            n_off += n
            # a request may have timed out (RequestTimeout) or been
            # cancelled while this bin was queued or computing — its
            # future is already resolved, and an unguarded set_result
            # would raise InvalidStateError and kill the worker
            try:
                if not r.future.done():
                    r.future.set_result(res)
                    delivered.append(r)
            except InvalidStateError:
                pass  # the timeout sweeper resolved it in the race window
        with self._lock:
            w.served_bins += 1
            w.served_graphs += len(delivered)
            w.busy_s += t_done - t0
            self._n_served += len(delivered)
            self._t_last_result = t_done
            self._latencies.extend(
                t_done - r.t_submit for r in delivered
            )
            self._bucket_bins[key] = self._bucket_bins.get(key, 0) + 1
            self._bucket_graphs[key] = (
                self._bucket_graphs.get(key, 0) + len(delivered)
            )

    # --------------------------- fleet management --------------------------

    def healthcheck(self) -> List[Dict[str, Any]]:
        """Per-worker liveness + counters (the fleet telemetry row).

        Note: deliberately NOT serialized on the rebuild lock — the fault
        drill polls this to observe a dead worker before the watchdog's
        rebuild replaces the fleet."""
        return self._healthcheck_rows()

    def _healthcheck_rows(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "worker": w.wid,
                    "alive": w.alive,
                    "served_bins": w.served_bins,
                    "served_graphs": w.served_graphs,
                    "busy_s": w.busy_s,
                    "beat_age_s": now - w.last_beat,
                    "error": repr(w.error) if w.error else None,
                }
                for w in self.workers
            ]

    def check_and_heal(self) -> bool:
        """One watchdog tick: if any worker died, drain-and-rebuild the
        fleet.  Returns True when a rebuild happened.  Serialized on the
        rebuild lock and re-checked under it, so a concurrent tick (or a
        manual call racing the watchdog) never rebuilds a just-rebuilt
        fleet a second time."""
        if self._stop.is_set():
            return False
        with self._rebuild_lock:
            if self._stop.is_set():
                return False
            with self._lock:
                dead = [w for w in self.workers if not w.alive]
            if not dead:
                return False
            self._drain_and_rebuild_locked(
                reason=f"dead workers: {[w.wid for w in dead]}"
            )
            return True

    def _watchdog_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.cfg.watchdog_s)
            try:
                self.check_and_heal()
            except Exception as exc:  # keep the watchdog alive
                log.warning("watchdog heal failed: %r", exc)

    def drain_and_rebuild(self, reason: str = "manual") -> Dict[str, Any]:
        """Stop the fleet at a bin boundary, requeue anything in flight,
        rebuild the engine (``close()`` + factory, fresh warm-up)
        and restart ``n_workers`` workers.  No request is dropped: futures
        stay pending across the rebuild and resolve once the new fleet
        picks their bins back up."""
        with self._rebuild_lock:
            return self._drain_and_rebuild_locked(reason=reason)

    def _drain_and_rebuild_locked(self, reason: str) -> Dict[str, Any]:
        t0 = time.perf_counter()
        # stop surviving workers at a bin boundary (poison pills), then
        # join; dead workers already requeued their own bin
        with self._lock:
            workers = list(self.workers)
        live = [w for w in workers if w.alive]
        for _ in live:
            self._bins.put(_STOP)
        for w in live:
            w.thread.join(timeout=10.0)
        # anything still marked in flight belonged to a worker that
        # could not finish — requeue it (no retry charge: the fleet was
        # torn down around it, the bin itself is not suspect)
        with self._lock:
            stranded = list(self._inflight.values())
            self._inflight.clear()
        for pbin in stranded:
            self._bins.put(pbin)
        # engine teardown + fresh warm build (a worker death may mean a
        # poisoned device context; a rebuilt engine warms and captures its
        # bucket set again and serving resumes)
        self._close_engine()
        self.engine = make_serve_engine(
            self.mace_cfg, self._params, self.buckets, device=self.device
        )
        with self._lock:
            self.workers = []
        self._spawn_workers(self.cfg.n_workers)
        event = {
            "reason": reason,
            "requeued_bins": len(stranded),
            "rebuild_s": time.perf_counter() - t0,
            "t": time.time(),
        }
        self.rebuild_events.append(event)
        log.info("serve fleet rebuilt: %s", event)
        return event

    def inject_worker_fault(self, wid: Optional[int] = None) -> int:
        """Fault drill (tests, chaos runs): make one worker raise on its
        next bin.  Returns the targeted worker id."""
        with self._lock:
            live = [w.wid for w in self.workers if w.alive]
        if not live:
            raise RuntimeError("no live workers to fault")
        target = live[0] if wid is None else wid
        self._fault_inject.add(target)
        return target

    # ------------------------------ telemetry ------------------------------

    def stats(self) -> Dict[str, Any]:
        """Serving telemetry: throughput, latency percentiles, per-bucket
        batching evidence, and fleet health.

        Serialized on the rebuild lock: a read that races an in-flight
        drain-and-rebuild would otherwise see the torn-down old engine
        (empty census) and the drained old fleet — it waits for the
        rebuild to land and reports the consistent post-rebuild state."""
        with self._rebuild_lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            served, failed = self._n_served, self._n_failed
            submitted = self._n_submitted
            t0, t1 = self._t_first_submit, self._t_last_result
            bucket_bins = dict(self._bucket_bins)
            bucket_graphs = dict(self._bucket_graphs)
        wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        return {
            "submitted": submitted,
            "served": served,
            "failed": failed,
            "wall_s": wall,
            "graphs_per_s": served / wall if wall > 0 else 0.0,
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else 0.0,
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else 0.0,
            "latency_mean_ms": float(lat.mean() * 1e3) if lat.size else 0.0,
            "bucket_bins": bucket_bins,
            "bucket_graphs": bucket_graphs,
            "compile_census": self.engine.compile_census(),
            "autotune_decisions": {kind: d.describe()
                                   for kind, d in self.autotune_decisions.items()},
            "workers": self._healthcheck_rows(),
            "rebuilds": len(self.rebuild_events),
        }
