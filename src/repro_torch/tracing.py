"""Spans and counters inside the port, on the clock of ``torch.profiler``.

A span is a named stretch of host time on one thread: its name, start and
end, the thread, its own id, the id of the span that caused it (its
parent), the id at the top of that chain (``root``: the training step or
the request it belongs to), attributes, and counters that ``count`` adds
while it is open.  Spans are kept in memory, one list per thread with no
lock on the hot path; ``spans()`` returns the finished ones and ``clear()``
drops them.  Nothing is written during a run.

When a span records:

* on a thread under an active ``torch.profiler`` session (the profiler's
  flag is thread-local, so this is the profiled stretch and nothing else);
* when its cause recorded: a span opened inside a recording span on the
  same thread, or given a recording ``parent`` from another thread (a
  request submitted under the profiler carries it to its bin and worker;
  a training step hands its bin's span to autograd's device thread, see
  ``handoff``, which besides inherits the profiler's thread-local state);
* everywhere after ``enable()``, for a run traced without the profiler.

Otherwise a span site checks a flag and records nothing: until something
has recorded in the process, the flag is the profiler's own process-wide
one, and only while a session is open anywhere are the thread's open span
and the profiler's thread-local flag read.

Times are ``time.perf_counter()`` seconds, the clock of the port's other
readings (``RankTelemetry``, ``GraphServer``), so a span can reuse a
reading taken at its boundary.  The exports put them on the profiler's
time base (epoch nanoseconds, ``time.time_ns``'s clock, which the
profiler's ``trace_start_ns`` and its events' microsecond offsets are on)
through one paired reading of both clocks.

Tracing a run::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train(max_steps=10)
    tracing.export_chrome_trace("run.json", prof)   # the spans beside the trace
    tracing.idle_gaps(prof)                          # the device's gaps, by span
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler

__all__ = ["Span", "span", "start", "add", "count", "handoff", "handed_off",
           "enable", "spans", "clear", "export_chrome_trace", "idle_gaps"]

_profiler_enabled = torch.autograd._profiler_enabled   # the thread-local flag
_enabled = False
_live = False   # enable() was called or a span recorded: the threads' stacks may hold one
_handoff: Optional["Span"] = None
_buffers: List[List["Span"]] = []      # every thread's list of finished spans
_buffers_lock = threading.Lock()       # taken once per thread, at its first span
_uids = itertools.count(1)


class _Local(threading.local):
    top: Optional["Span"] = None       # the innermost span open on this thread
    buffer: Optional[List["Span"]] = None
    name: Optional[str] = None


_local = _Local()


def _buffer() -> List["Span"]:
    buf = _local.buffer
    if buf is None:
        buf = _local.buffer = []
        _local.name = threading.current_thread().name
        with _buffers_lock:
            _buffers.append(buf)
    return buf


class Span:
    """One recorded span; ``t0``/``t1`` are ``perf_counter`` seconds."""

    __slots__ = ("name", "id", "uid", "parent", "root", "depth", "thread", "t0", "t1",
                 "attrs", "counts")

    def __init__(self, name: str, parent: Optional["Span"], id: Any, t0: Optional[float],
                 attrs: Dict[str, Any]):
        global _live
        _live = True
        self.uid = next(_uids)
        self.name = name
        self.id = self.uid if id is None else id
        self.parent = None if parent is None else parent.uid
        self.root = self.id if parent is None else parent.root
        self.depth = 0 if parent is None else parent.depth + 1
        _buffer()
        self.thread = _local.name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.counts: Dict[str, float] = {}

    def count(self, name: str, n: float = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def end(self, t: Optional[float] = None) -> None:
        """Close the span at ``t`` (``perf_counter`` seconds; now by
        default), on any thread; a second call changes nothing."""
        if self.t1 is None:
            self.t1 = time.perf_counter() if t is None else t
            _buffer().append(self)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def start(name: str, parent: Optional[Span] = None, *, id: Any = None,
          t0: Optional[float] = None, **attrs) -> Optional[Span]:
    """Open a span that some later call ends (``Span.end``), possibly on
    another thread; None when it does not record.  ``parent`` defaults to
    the innermost span open on this thread; ``t0`` to now."""
    if parent is None:
        if not (_live or _torch_profiler._is_profiler_enabled):
            return None
        parent = _local.top
        if parent is None and not (_enabled or _profiler_enabled()):
            return None
    return Span(name, parent, id, t0, attrs)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Open:
    __slots__ = ("span", "prev")

    def __init__(self, sp: Span):
        self.span = sp

    def __enter__(self) -> Span:
        self.prev = _local.top
        _local.top = self.span
        return self.span

    def __exit__(self, *exc_info):
        _local.top = self.prev
        self.span.end()
        return False


def span(name: str, parent: Optional[Span] = None, *, id: Any = None,
         t0: Optional[float] = None, **attrs):
    """Context manager over one span, which is the innermost open span of
    this thread inside it; it yields the ``Span``, or None when it does not
    record."""
    if parent is None:
        if not (_live or _torch_profiler._is_profiler_enabled):
            return _OFF
        parent = _local.top
        if parent is None and not (_enabled or _profiler_enabled()):
            return _OFF
    return _Open(Span(name, parent, id, t0, attrs))


def add(name: str, t0: float, t1: float, parent: Optional[Span] = None, **attrs
        ) -> Optional[Span]:
    """A finished span from two readings already taken (``perf_counter``
    seconds)."""
    sp = start(name, parent, t0=t0, **attrs)
    if sp is not None:
        sp.end(t1)
    return sp


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` of this thread's innermost open
    span, if one records."""
    sp = _local.top
    if sp is not None:
        sp.count(name, n)


class _Handoff:
    __slots__ = ("span", "prev")

    def __init__(self, sp: Span):
        self.span = sp

    def __enter__(self):
        global _handoff
        self.prev, _handoff = _handoff, self.span
        return self.span

    def __exit__(self, *exc_info):
        global _handoff
        _handoff = self.prev
        return False


def handoff(sp: Optional[Span]):
    """Context manager: while it is open, ``handed_off()`` returns ``sp``, so
    that work this span causes on another thread (autograd's device thread,
    which runs a CUDA backward) names it as its parent."""
    return _OFF if sp is None else _Handoff(sp)


def handed_off() -> Optional[Span]:
    return _handoff


def enable(on: bool = True) -> None:
    """Record every span from now on (``enable(False)`` returns to
    recording under the profiler only)."""
    global _enabled, _live
    _enabled = bool(on)
    _live = _live or _enabled


def spans(*names: str) -> List[Span]:
    """The finished spans, oldest first; only those of ``names`` if given."""
    with _buffers_lock:
        bufs = list(_buffers)
    out = [s for b in bufs for s in list(b) if not names or s.name in names]
    out.sort(key=lambda s: s.t0)
    return out


def clear() -> None:
    """Drop every recorded span."""
    global _handoff
    with _buffers_lock:
        for b in _buffers:
            b.clear()
    _handoff = None


# ----------------------------- the profiler's clock --------------------------


def epoch_offset_ns() -> int:
    """Nanoseconds to add to ``perf_counter`` nanoseconds to reach the
    profiler's clock, from the tightest of five paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


def to_epoch_ns(t: float, offset_ns: int) -> int:
    return int(round(t * 1e9)) + offset_ns


def trace_start_ns(prof) -> int:
    """The epoch nanoseconds of a ``torch.profiler`` trace's time 0."""
    return int(prof.profiler.kineto_results.trace_start_ns())


def export_chrome_trace(path: str, prof=None) -> int:
    """Write the spans to ``path`` as Chrome-trace events, one track per
    thread, attributes and counters under ``args``, on the profiler's
    clock: epoch nanoseconds = ``baseTimeNanoseconds`` + ``ts`` x 1000, the
    convention of the profiler's own export.  With ``prof`` (a stopped
    ``torch.profiler.profile``) the file is the profiler's export with the
    spans merged in, so host spans and device activity share one timeline.
    Returns the number of spans written."""
    if prof is not None:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    else:
        data = {"traceEvents": [], "displayTimeUnit": "ms"}
    off = epoch_offset_ns()
    done = spans()
    base = data.get("baseTimeNanoseconds")
    if base is None:
        first = min((to_epoch_ns(s.t0, off) for s in done), default=time.time_ns())
        base = data["baseTimeNanoseconds"] = first - first % 10**9
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events = data["traceEvents"]
    for s in done:
        tid = tids.setdefault(s.thread, 900_000_000 + len(tids))
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": tid,
            "ts": (to_epoch_ns(s.t0, off) - base) / 1e3, "dur": s.seconds * 1e6,
            "args": {"id": s.id, "root": s.root, "uid": s.uid, "parent": s.parent,
                     **s.attrs, **s.counts}})
    for name, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"spans: {name}"}})
    with open(path, "w") as f:
        json.dump(data, f)
    return len(done)


def idle_gaps(prof, top: Optional[int] = 10) -> List[Dict[str, Any]]:
    """The longest gaps in which no operation ran on the device, longest
    first (every gap with ``top=None``), over a stopped
    ``torch.profiler.profile``: ``{"s": seconds, "span": the innermost span
    open at the gap's start (the deepest across the traced threads, None if
    none was), "id", "root", "thread", "before": the device operation that
    ended the gap}``.  The device's operations are the trace's CUDA events,
    or, in a trace that has none (a CPU run), its CPU operations."""
    from torch.autograd import DeviceType

    events = prof.events()
    ops = ([e for e in events if e.device_type == DeviceType.CUDA]
           or [e for e in events if e.device_type == DeviceType.CPU])
    gaps, end = [], None
    for s, t, name in sorted((e.time_range.start, e.time_range.end, e.name) for e in ops):
        if end is not None and s > end:
            gaps.append((s - end, end, name))
        end = t if end is None else max(end, t)
    gaps.sort(key=lambda g: -g[0])
    gaps = gaps if top is None else gaps[:top]
    # one sweep over the gaps' starts and the spans' ends, in time order
    t_base, off = trace_start_ns(prof), epoch_offset_ns()
    marks = []
    for sp in spans():
        marks.append((to_epoch_ns(sp.t0, off), 1, sp))
        marks.append((to_epoch_ns(sp.t1, off), 0, sp))
    for k, (_, at_us, _) in enumerate(gaps):
        marks.append((t_base + int(round(at_us * 1e3)), 2, k))
    marks.sort(key=lambda m: (m[0], m[1]))
    open_spans: Dict[int, Span] = {}
    at_gap: Dict[int, Optional[Span]] = {}
    for _, kind, x in marks:
        if kind == 1:
            open_spans[x.uid] = x
        elif kind == 0:
            open_spans.pop(x.uid, None)
        else:
            at_gap[x] = max(open_spans.values(), key=lambda s: (s.depth, s.t0), default=None)
    out = []
    for k, (gap_us, _, before) in enumerate(gaps):
        sp = at_gap[k]
        out.append({"s": gap_us / 1e6, "span": sp and sp.name, "id": sp and sp.id,
                    "root": sp and sp.root, "thread": sp and sp.thread, "before": before})
    return out
