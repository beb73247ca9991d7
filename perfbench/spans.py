"""The port's spans, for the per-layer readers that read them.

``repro_torch.tracing`` keeps the spans of a run in memory, and they record
only under the profiler, so in a run of the benchmark (one process, whose
one profiled stretch is the harness's) they are the stretch's steps,
requests and bins, with what those caused on other threads.  A program
without the tracer gives none, and its readers None.
"""
from __future__ import annotations

from typing import List


def spans(*names: str) -> List:
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return tracing.spans(*names)


def per(total_s: float, n: int):
    """``total_s`` in ms over ``n``, or None when ``n`` is 0."""
    return 1e3 * total_s / n if n else None
