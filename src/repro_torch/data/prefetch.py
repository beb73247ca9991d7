"""Async host prefetch: overlap bin collation with device compute.

Copy of the JAX package's ``data/prefetch.py`` (pure Python threads), cut to
what the port's sequential trainer uses.  The fetch callable collates to
numpy only: the trainer moves each batch to the device on its own thread,
so no CUDA work runs on the producer.

* **Bounded lookahead** — one producer thread pulls sampler items (index
  lists), runs the fetch callable, and parks finished batches in a
  ``queue.Queue(maxsize=depth)``.  ``depth=1`` is double buffering;
  ``depth=0`` runs the same loop inline, with no thread.
* **Order** — items are fetched strictly in sampler order by one thread, so
  the batch stream equals the inline loop's.
* **Clean shutdown** — ``close()`` (or leaving the ``with`` block) stops the
  producer even when the queue is full: its ``put`` polls the stop flag.
* **Errors** — a producer-side error is re-raised in the consumer at the
  step where the inline loop would have raised it.  One still in flight at
  an early exit (``max_steps``) is kept on :attr:`error` by ``close()`` and
  re-raised by :meth:`raise_pending`.
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

__all__ = ["PrefetchItem", "PrefetchPipeline"]

# producer poll period for stop-flag re-checks while the queue is full
_PUT_POLL_S = 0.05

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefetchItem:
    """One prefetched step: the sampler item, its batch, and host timings."""

    index: int          # step ordinal within this pipeline's stream
    item: Any           # the sampler item (e.g. one list of indices per rank)
    batch: Any          # fetch(item) result
    collate_s: float    # host wall seconds spent inside fetch()
    wait_s: float       # seconds the consumer blocked before receiving it


class _EndOfStream:
    pass


_END = _EndOfStream()


def _produce(items: Iterator[Any], fetch: Callable[[Any], Any],
             q: "queue.Queue", stop: threading.Event) -> None:
    """Producer loop.  A module-level function on purpose: the thread holds
    no reference to the ``PrefetchPipeline``, so an abandoned pipeline stays
    garbage-collectable and its ``weakref.finalize`` can stop this loop."""

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
            t0 = time.perf_counter()
            batch = fetch(item)
            dt = time.perf_counter() - t0
            if not put(PrefetchItem(i, item, batch, dt, 0.0)):
                return
    except BaseException as exc:  # propagate into the consumer
        put(exc)
    else:
        put(_END)


class PrefetchPipeline:
    """Iterate ``fetch(item)`` over ``items`` with bounded async lookahead.

    ``items`` is iterated on the producer thread, so it must be safe to
    iterate off-thread (``BalancedBatchSampler.step_iter`` snapshots its
    state up front for this).  ``fetch(item) -> batch`` is the host work.
    ``depth`` is the number of finished batches allowed ahead of the
    consumer; ``0`` fetches inline.  Use as a context manager (or call
    :meth:`close`); iterating yields one :class:`PrefetchItem` per step.
    """

    def __init__(self, items: Iterable[Any], fetch: Callable[[Any], Any],
                 depth: int = 1):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.depth = depth
        self._fetch = fetch
        self._items: Iterator[Any] = iter(items)
        self._index = 0
        #: a producer exception (captured when the consumer raises it, or
        #: when close() finds one still in flight) — never silently lost
        self.error: Optional[BaseException] = None
        self._error_delivered = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional["queue.Queue"] = None
        if depth >= 1:
            self._queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(
                target=_produce,
                args=(self._items, fetch, self._queue, self._stop),
                name="prefetch-collate",
                daemon=True,
            )
            self._thread.start()
            # a pipeline dropped without close() stops its producer on GC
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
                # re-raising it verbatim from __next__ would silently end
                # the stream (PEP 479) instead of surfacing the error
                raise RuntimeError(
                    "prefetch fetch raised StopIteration"
                ) from payload
            raise payload
        payload.wait_s = wait
        return payload

    # ----------------------------- lifecycle ------------------------------

    def close(self) -> None:
        """Stop the producer and join it.  Idempotent; never deadlocks: the
        producer's put loop re-checks the stop flag, and the queue is
        drained here so a blocked put always unblocks.  Finished batches
        still in flight are dropped; an in-flight producer exception is
        kept on :attr:`error` for :meth:`raise_pending`."""
        self._stop.set()
        if self._thread is None:
            return
        while self._thread.is_alive():
            self._drain_queue()
            self._thread.join(timeout=_PUT_POLL_S)
        self._thread = None
        # the producer may have enqueued its exception and exited before
        # close() was called: one final drain so it is not lost
        self._drain_queue()

    def _drain_queue(self) -> None:
        if self._queue is None:
            return
        try:
            while True:
                payload = self._queue.get_nowait()
                if isinstance(payload, BaseException):
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
        (one drained by :meth:`close` at an early exit).  No-op when the
        stream ended cleanly or the error already surfaced in ``__next__``;
        raises at most once."""
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
