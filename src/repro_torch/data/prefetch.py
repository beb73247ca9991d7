"""Async host prefetch: overlap bin collation with device compute.

Copy of the JAX package's ``data/prefetch.py`` (pure Python threads).  The
fetch callable collates to numpy only: the trainer moves each batch to the
device on its own thread, so no CUDA work runs on the producer.

* **Bounded lookahead** — one producer thread pulls sampler items (index
  lists), runs the fetch callable, and parks finished batches in a
  ``queue.Queue(maxsize=depth)``.  ``depth=1`` is double buffering;
  ``depth=0`` runs the same loop inline, with no thread.
* **Order** — items are fetched strictly in sampler order by one thread, so
  the batch stream equals the inline loop's.
* **Clean shutdown** — ``close()`` (or leaving the ``with`` block) stops the
  producer even when the queue is full: its ``put`` polls the stop flag.
* **Drain-and-rebuild (elastic rescale)** — a mid-run rescale changes the
  batch layout (one bin per rank), so in-flight batches collated at the old
  rank count are unusable.  ``close()`` *discards* them (the count lands in
  :attr:`discarded`); correctness is unaffected because the sampler cursor
  only advances for *consumed* steps, and the rescaled sampler re-derives
  exactly the un-consumed remainder (``train_loop.Trainer.rescale`` reports
  the discard count per event).
* **Errors** — a producer-side error is re-raised in the consumer at the
  step where the inline loop would have raised it.  One still in flight at
  an early exit (rescale drain, ``max_steps``) is kept on :attr:`error` by
  ``close()`` and re-raised by :meth:`raise_pending`.
* **Stall watchdog** — with ``stall_deadline_s`` set, a producer stuck
  inside one ``fetch`` past the deadline is reported by :meth:`stalled`,
  raised once as :class:`ProducerStalled` by :meth:`raise_pending`, and
  abandoned (a daemon thread) by ``close()`` instead of joined forever.
* **Timings** — every :class:`PrefetchItem` carries ``collate_s`` (host
  seconds spent building the batch) and ``wait_s`` (seconds the consumer
  blocked for it), which the trainer's telemetry turns into the collate
  time hidden behind the device.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, Optional

__all__ = ["PrefetchItem", "PrefetchPipeline", "ProducerStalled"]

# producer poll period for stop-flag re-checks while the queue is full
_PUT_POLL_S = 0.05

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefetchItem:
    """One prefetched step: the sampler item, its batch, and host timings."""

    index: int          # step ordinal within this pipeline's stream
    item: Any           # the sampler item (e.g. one list of indices per rank)
    batch: Any          # fetch(item) result (collated device batch)
    collate_s: float    # host wall seconds spent inside fetch()
    wait_s: float       # seconds the consumer blocked before receiving it

    @property
    def overlap_s(self) -> float:
        """Collate seconds hidden behind device compute for this step."""
        return max(self.collate_s - self.wait_s, 0.0)


class _EndOfStream:
    pass


_END = _EndOfStream()


class ProducerStalled(RuntimeError):
    """The prefetch producer has been stuck inside one ``fetch`` call for
    longer than ``stall_deadline_s`` — alive, but making no progress (a
    hung data source, a deadlocked collate)."""


def _produce(items: Iterator[Any], fetch: Callable[[Any], Any],
             q: "queue.Queue", stop: threading.Event,
             progress: dict) -> None:
    """Producer loop.  A module-level function on purpose: the thread must
    hold no reference to the ``PrefetchPipeline`` itself, so an abandoned
    pipeline (no ``close()``) stays garbage-collectable and its
    ``weakref.finalize`` can stop this loop.  ``progress`` (a plain dict,
    also pipeline-reference-free) is this thread's liveness record: state
    transitions (idle / fetch) are stamped with a monotonic time so the
    consumer can tell a *stalled* fetch from a merely slow one."""

    def put(payload: Any) -> bool:
        # blocking put that aborts (False) once the stop flag is raised
        while not stop.is_set():
            try:
                q.put(payload, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    try:
        for i, item in enumerate(items):
            if stop.is_set():
                return
            progress.update(state="fetch", index=i, t=time.monotonic())
            t0 = time.perf_counter()
            batch = fetch(item)
            dt = time.perf_counter() - t0
            progress.update(state="idle", index=i, t=time.monotonic())
            if not put(PrefetchItem(i, item, batch, dt, 0.0)):
                return
    except BaseException as exc:  # propagate into the consumer
        progress.update(state="idle", t=time.monotonic())
        put(exc)
    else:
        progress.update(state="idle", t=time.monotonic())
        put(_END)


class PrefetchPipeline:
    """Iterate ``fetch(item)`` over ``items`` with bounded async lookahead.

    Parameters
    ----------
    items:
        Iterable of cheap, picklable-in-spirit work descriptors (the
        sampler's per-step index bins).  Consumed eagerly-in-order by the
        producer thread; it must therefore be safe to iterate off-thread —
        ``BalancedBatchSampler.step_iter`` snapshots its state up front for
        exactly this reason.
    fetch:
        ``fetch(item) -> batch`` — the expensive host work (dataset.get +
        ``engine.collate``).  Runs on the producer thread when ``depth>=1``.
    depth:
        Number of finished batches allowed in flight ahead of the consumer.
        ``0`` = synchronous inline fetch (no thread).
    stall_deadline_s:
        When set, a producer that has been inside ONE ``fetch`` call for
        longer than this is reported as *stalled* (alive but wedged):
        :meth:`stalled` returns a diagnosis, :meth:`raise_pending` raises
        :class:`ProducerStalled`, and :meth:`close` gives up joining after
        the deadline — logging, capturing the stall on :attr:`error`, and
        abandoning the daemon thread instead of blocking forever on a
        fetch that will never return.  ``None`` (default) keeps the
        previous join-forever behaviour.

    Use as a context manager (or call :meth:`close`); iterating yields
    :class:`PrefetchItem` per step.
    """

    def __init__(
        self,
        items: Iterable[Any],
        fetch: Callable[[Any], Any],
        depth: int = 1,
        *,
        stall_deadline_s: Optional[float] = None,
    ):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        if stall_deadline_s is not None and stall_deadline_s <= 0:
            raise ValueError(
                f"stall_deadline_s must be positive, got {stall_deadline_s}"
            )
        self.depth = depth
        self.stall_deadline_s = stall_deadline_s
        self._fetch = fetch
        self._items: Iterator[Any] = iter(items)
        self._index = 0
        #: finished batches thrown away by close() — in-flight work a
        #: drain-and-rebuild (elastic rescale, early exit) chose not to use
        self.discarded = 0
        #: a producer exception (captured when the consumer raises it, or
        #: when close() finds one still in flight) — never silently lost
        self.error: Optional[BaseException] = None
        self._error_delivered = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional["queue.Queue"] = None
        # producer liveness record (written only by the producer thread;
        # holds no pipeline reference so GC-finalization still works)
        self._progress = {"state": "idle", "index": None, "t": time.monotonic()}
        if depth >= 1:
            self._queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=_produce,
                args=(self._items, fetch, self._queue, self._stop,
                      self._progress),
                name="prefetch-collate",
                daemon=True,
            )
            self._thread.start()
            # safety net for pipelines abandoned without close(): the
            # producer holds no reference to self (see _produce), so GC of
            # the pipeline raises the stop flag and the thread exits
            self._finalizer = weakref.finalize(self, self._stop.set)

    # ----------------------------- consumer -------------------------------

    def __iter__(self) -> "PrefetchPipeline":
        return self

    def __next__(self) -> PrefetchItem:
        if self._stop.is_set():
            raise StopIteration
        if self._queue is None:  # depth 0: inline, nothing hidden
            try:
                item = next(self._items)
            except StopIteration:
                self.close()
                raise
            t0 = time.perf_counter()
            try:
                batch = self._fetch(item)
            except StopIteration as exc:
                # PEP-479 style: never let a leaked StopIteration masquerade
                # as a normal end of the epoch stream
                self.close()
                raise RuntimeError("prefetch fetch raised StopIteration") from exc
            dt = time.perf_counter() - t0
            out = PrefetchItem(self._index, item, batch, dt, dt)
            self._index += 1
            return out
        t0 = time.perf_counter()
        payload = self._queue.get()
        wait = time.perf_counter() - t0
        if payload is _END:
            self.close()
            raise StopIteration
        if isinstance(payload, BaseException):
            self.error = payload
            self._error_delivered = True
            self.close()
            if isinstance(payload, StopIteration):
                # a StopIteration leaked out of fetch on the producer side;
                # re-raising it verbatim from __next__ would silently end
                # the stream (PEP 479) instead of surfacing the error
                raise RuntimeError(
                    "prefetch fetch raised StopIteration"
                ) from payload
            raise payload
        payload.wait_s = wait
        return payload

    # ----------------------------- lifecycle ------------------------------

    def stalled(self) -> Optional[str]:
        """Diagnose a stalled producer: a live thread that has been inside
        one ``fetch`` call for longer than ``stall_deadline_s``.  Returns a
        human-readable diagnosis naming the stuck item, or None (healthy,
        no deadline configured, no thread, or producer already gone)."""
        if (
            self.stall_deadline_s is None
            or self._thread is None
            or not self._thread.is_alive()
        ):
            return None
        p = dict(self._progress)  # snapshot: the producer writes it live
        if p.get("state") != "fetch":
            return None
        age = time.monotonic() - p["t"]
        if age <= self.stall_deadline_s:
            return None
        return (
            f"prefetch producer stalled: fetch of item {p.get('index')} "
            f"has been running for {age:.1f}s "
            f"(> {self.stall_deadline_s:.1f}s stall deadline) — alive but "
            f"making no progress"
        )

    def close(self) -> None:
        """Stop the producer and join it.  Idempotent; never deadlocks —
        the producer's put loop re-checks the stop flag, and the queue is
        drained here so a blocked put always unblocks.  Finished batches
        still in flight are discarded (counted in :attr:`discarded`) — the
        drain half of the rescale path's drain-and-rebuild.  An in-flight
        producer *exception* is never discarded with them: it is captured
        on :attr:`error` and logged, so deliberate early exits can surface
        it via :meth:`raise_pending`.

        A producer wedged *inside* ``fetch`` cannot observe the stop flag;
        with ``stall_deadline_s`` set, close() detects that (via
        :meth:`stalled`), logs it, captures a :class:`ProducerStalled` on
        :attr:`error`, and abandons the daemon thread rather than joining
        forever."""
        self._stop.set()
        if self._thread is None:
            return
        while self._thread.is_alive():
            self._drain_queue()
            self._thread.join(timeout=_PUT_POLL_S)
            msg = self.stalled()
            if msg is not None:
                _log.warning(
                    "prefetch close(): %s; abandoning daemon producer", msg
                )
                if self.error is None:
                    self.error = ProducerStalled(msg)
                break
        self._thread = None
        # the producer may have finished BEFORE close() was called (e.g. it
        # enqueued its exception and exited): the queue still needs one
        # final drain or that error would sit there unobserved
        self._drain_queue()

    def _drain_queue(self) -> None:
        if self._queue is None:
            return
        try:
            while True:
                payload = self._queue.get_nowait()
                if isinstance(payload, PrefetchItem):
                    self.discarded += 1
                elif isinstance(payload, BaseException):
                    # a real collate failure raced the shutdown; a plain
                    # drain would mask it (the original bug)
                    if self.error is None:
                        self.error = payload
                    _log.warning(
                        "prefetch close() drained an undelivered "
                        "producer exception: %r", payload,
                    )
        except queue.Empty:
            pass

    def raise_pending(self) -> None:
        """Re-raise a producer exception that the consumer never received
        (one drained by :meth:`close` during an early exit), or raise
        :class:`ProducerStalled` for a producer that is alive but stuck in
        one ``fetch`` past ``stall_deadline_s`` — a stalled producer must
        be as loud as a dead one.  No-op when the stream ended cleanly or
        the error already surfaced in ``__next__``.  Like the dead-producer
        path, a stall is delivered once — teardown code often calls this
        from several unwind points and must not fail twice for one fault."""
        msg = self.stalled()
        if msg is not None and not self._error_delivered:
            self.error = self.error or ProducerStalled(msg)
            self._error_delivered = True
            raise ProducerStalled(msg)
        if self.error is not None and not self._error_delivered:
            self._error_delivered = True
            if isinstance(self.error, StopIteration):
                raise RuntimeError(
                    "prefetch fetch raised StopIteration"
                ) from self.error
            raise self.error

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
