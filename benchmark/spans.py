"""Reductions of the program's own spans and counters (its ``utils/trace``
recorder, read in process after a run) to per-layer metrics, shared by
the readers in ``metrics/``: a span's median a call, its self time and
total, a counter, and the profiled stretch's device idle put down to the
program's spans.

A program without the recorder, or without the span or counter a reader
asks for, gives ``None``: the metric is left out of the line. The program
is imported inside the functions, as the drivers import it.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, Optional

from .harness import PROGRAM

# Kineto writes a trace's ``ts`` relative to ``baseTimeNanoseconds``: the
# wall clock rounded down to a multiple of this many seconds
TRACE_BASE_S = 7889238
# the spans in which the host copies to or from the card
COPIES = ("forward.copy_in", "forward.copy_out", "fusion.upload", "fusion.download")
CALLER = ""


def snapshot() -> Optional[Dict]:
    """The program's recorder's ``snapshot()``, or ``None`` where the
    program has none."""
    import importlib

    try:
        trace = importlib.import_module(f"{PROGRAM}.utils.trace")
    except ImportError:
        return None
    return trace.snapshot()


def _span(name: str) -> Optional[Dict]:
    snap = snapshot()
    return None if snap is None else snap["spans"].get(name)


def median_ms(name: str) -> Optional[float]:
    """The median of span ``name``'s recent durations, in ms."""
    s = _span(name)
    return None if s is None else 1e3 * statistics.median(s["recent_s"])


def summed_s(name: str, key: str = "total_s") -> Optional[float]:
    """Span ``name``'s durations summed (``total_s``), or their self times
    (``self_s``: less the parts their child spans cover), in s; 0 where the
    recorder saw none."""
    snap = snapshot()
    if snap is None:
        return None
    return snap["spans"].get(name, {}).get(key, 0.0)


def counter(name: str) -> Optional[int]:
    """Counter ``name``; 0 where nothing was counted."""
    snap = snapshot()
    return None if snap is None else snap["counters"].get(name, 0)


def per_call(counter_name: str, span_name: str) -> Optional[float]:
    """Counter ``counter_name`` over the number of ``span_name`` spans."""
    s = _span(span_name)
    n = counter(counter_name)
    return None if s is None or n is None else n / s["count"]


def base_ns(trace: Dict, wall_ns: int) -> int:
    """The trace's ``baseTimeNanoseconds`` for a profile taken at
    ``wall_ns`` (``time.time_ns()``); 0 where its times are absolute."""
    if trace["kernels"][0][1] > TRACE_BASE_S:
        return 0
    unit = TRACE_BASE_S * 1_000_000_000
    return wall_ns // unit * unit


def idle_by_span(res: Dict) -> Optional[Dict[str, float]]:
    """The profiled stretch's inner device idle (the gaps between the
    merged device intervals of ``res["trace"]["kernels"]``) in seconds an
    iteration, by the innermost program span of the recorder's timeline
    open at each gap's middle (``CALLER`` where none is)."""
    trace = res.get("trace") or {}
    snap = snapshot()
    if not trace.get("kernels") or snap is None or not snap["timeline"]:
        return None
    timeline = snap["timeline"]
    base = base_ns(trace, min(t[1] for t in timeline))
    # (start, end, name) in the trace's seconds, by start
    spans = sorted(((s - base) * 1e-9, (e - base) * 1e-9, name) for name, s, e in timeline)
    starts = [s[0] for s in spans]
    merged = []
    for _, a, d in sorted(trace["kernels"], key=lambda k: k[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], a + d)
        else:
            merged.append([a, a + d])
    idle: Dict[str, float] = defaultdict(float)
    for (_, b), (a, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        name = CALLER
        # the innermost open span is the latest to open among those open
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[i][1] >= mid:
                name = spans[i][2]
                break
        idle[name] += (a - b) / trace["iters"]
    return dict(idle)


def idle_ms(res: Dict, keep) -> Optional[float]:
    """Idle ms an iteration of ``idle_by_span`` over the span names for
    which ``keep(name)`` holds."""
    idle = idle_by_span(res)
    return None if idle is None else 1e3 * sum(s for n, s in idle.items() if keep(n))
