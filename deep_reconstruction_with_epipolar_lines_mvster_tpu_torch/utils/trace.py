"""Spans and counters of the port: where its host time goes, always on.

``span(name)`` times a block of host code; ``count(name, n)`` adds to a
named integer. The port opens its spans where the work happens:

- ``forward`` and its children ``forward.copy_in``, ``forward.wait`` and
  ``forward.copy_out`` (``eval/depthgen.run_forward``);
- ``fusion.view`` (``eval/scene_filter.fuse_view``), ``fusion.filter``
  with ``fusion.upload`` and ``fusion.download``
  (``eval/fusion.filter_ref_view``), ``fusion.gather``
  (``eval/fusion.fused_world_points``);
- ``graph.replay`` and ``graph.capture``, counter ``graph.captures``
  (``utils/graphs``: a captured function's call, the first of a new input
  signature);
- ``feed``, counter ``feed.bytes`` (``data/synthetic.batch_to_torch``);
- ``kernels.load``, counters ``kernels.built`` and, one a kernel of
  ``KERNELS``, ``<kernel>.launches`` (``ops/_build``);
- ``fit.step``, ``fit.val_step`` and ``data.wait`` (``train/loop.fit``);
- ``dcn``, counter ``dcn.samples`` (``models/fpn.NADCN``: each DCN head);
- ``convnext``, counter ``convnext.pixels`` (``models/fpn.ConvNeXtBlock``
  and ``ConvNeXt4Block``: each ConvNeXt block of the pyramid).

For each span name the recorder keeps the number of spans closed, their
total and self time (a span's duration less the part its child spans
cover) and a ring of the last ``RING`` durations. A span's parent is the
span open on the same thread when it opened. None of this grows with the
length of a run.

While a ``torch.profiler`` profile is active (the profiler's own flag,
read on every span), each span also opens the profiler range
``mvster.<name>``, so that it shows on the trace beside the device work,
and is appended to a timeline as ``(name, start, end)`` in
``time.time_ns()``: the trace's clock is its events' ``ts`` (us) plus its
``baseTimeNanoseconds``. The timeline holds at most ``TIMELINE`` spans
and counts those it drops. Without a profiler no range is opened: a
``record_function`` costs about 13 us a use.

The recorder is one per process and writes nothing to disk;
``snapshot()`` hands its state to the caller, ``reset()`` clears it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

RING = 4096          # a power of two
_RING_MASK = RING - 1
TIMELINE = 1 << 16
PREFIX = "mvster."

_perf_ns = time.perf_counter_ns
_wall_ns = time.time_ns


class _Stat:
    """A span name's aggregates on one thread, in nanoseconds: the number
    of spans, and the durations and self times of the last ``RING`` in two
    rings. Each time the rings fill they are added to ``total`` and
    ``self_time``, so that closing a span writes two slots and a count."""

    __slots__ = ("count", "ring", "selfs", "total", "self_time")

    def __init__(self):
        self.count = 0
        self.ring = [0] * RING
        self.selfs = [0] * RING
        self.total = 0
        self.self_time = 0

    def summary(self) -> "_Summary":
        n = self.count & _RING_MASK
        if self.count <= RING:
            recent = self.ring[:self.count]
        else:
            recent = self.ring[n:] + self.ring[:n]
        return (self.count, self.total + sum(self.ring[:n]),
                self.self_time + sum(self.selfs[:n]), recent)


# (count, total, self time, the last ``RING`` durations oldest first)
_Summary = Tuple[int, int, int, List[int]]


def _merge(a: _Summary, b: _Summary) -> _Summary:
    """``a``'s spans and then ``b``'s."""
    return a[0] + b[0], a[1] + b[1], a[2] + b[2], (a[3] + b[3])[-RING:]


class _Thread:
    """One thread's open span and its span aggregates: only that thread
    writes them, so closing a span takes no lock."""

    __slots__ = ("top", "stats")

    def __init__(self):
        self.top: Optional[Span] = None
        self.stats: Dict[str, _Stat] = {}


_lock = threading.Lock()
_threads: List[Tuple[threading.Thread, _Thread]] = []
_retired: Dict[str, _Summary] = {}       # the aggregates of threads that ended
_counters: Dict[str, int] = {}
_timeline: List[Tuple[str, int, int]] = []
_dropped = 0


def _register() -> _Thread:
    """A new thread's state; the aggregates of threads that have ended are
    merged into ``_retired``, so that they take no more room."""
    state = _Thread()
    with _lock:
        for thread, old in [x for x in _threads if not x[0].is_alive()]:
            _threads.remove((thread, old))
            for name, st in old.stats.items():
                _retired[name] = _merge(_retired.get(name, (0, 0, 0, [])), st.summary())
        _threads.append((threading.current_thread(), state))
    return state


class _Local(threading.local):
    def __init__(self):
        self.state = _register()


_LOCAL = _Local()


class Span:
    """``with span(name):`` times its block; after the block ``seconds`` is
    its duration. A span made while a profiler is active is a
    ``_ProfiledSpan`` instead."""

    __slots__ = ("name", "state", "parent", "child", "start", "dur", "wall", "mark")

    # the keyword defaults bind globals as locals: this is the hot path
    def __init__(self, name: str, _profiler=_profiler):
        self.name = name
        if _profiler._is_profiler_enabled:
            self.__class__ = _ProfiledSpan

    @property
    def seconds(self) -> float:
        return self.dur * 1e-9

    def __enter__(self, _perf_ns=_perf_ns, _local=_LOCAL) -> "Span":
        self.state = state = _local.state
        self.parent = state.top
        state.top = self
        self.child = 0
        self.start = _perf_ns()
        return self

    def __exit__(self, exc_type, exc, tb, _perf_ns=_perf_ns, _Stat=_Stat) -> None:
        self.dur = dur = _perf_ns() - self.start
        state = self.state
        state.top = parent = self.parent
        if parent is not None:
            parent.child += dur
        try:
            st = state.stats[self.name]
        except KeyError:
            st = state.stats[self.name] = _Stat()
        n = st.count
        i = n & _RING_MASK
        st.ring[i] = dur
        st.selfs[i] = dur - self.child
        st.count = n + 1
        if i == _RING_MASK:
            st.total += sum(st.ring)
            st.self_time += sum(st.selfs)


class _ProfiledSpan(Span):
    """A span made while a profiler is active: also a profiler range and a
    timeline entry, both outside the span's duration."""

    __slots__ = ()

    def __enter__(self) -> "Span":
        self.wall = _wall_ns()
        self.mark = torch.profiler.record_function(PREFIX + self.name)
        self.mark.__enter__()
        return Span.__enter__(self)

    def __exit__(self, exc_type, exc, tb) -> None:
        global _dropped
        Span.__exit__(self, exc_type, exc, tb)
        self.mark.__exit__(None, None, None)
        entry = (self.name, self.wall, _wall_ns())
        with _lock:
            if len(_timeline) < TIMELINE:
                _timeline.append(entry)
            else:
                _dropped += 1


span = Span


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def reset() -> None:
    """Forget every span, counter and timeline entry. Spans open on any
    thread meanwhile may be counted in part."""
    global _dropped
    with _lock:
        for _, state in _threads:
            state.stats.clear()
        _retired.clear()
        _counters.clear()
        _timeline.clear()
        _dropped = 0


def snapshot() -> Dict:
    """The recorder's state: ``spans`` (per name: ``count``, ``total_s``,
    ``self_s`` and ``recent_s``, the last ``RING`` durations, oldest
    first), ``counters``, ``timeline`` (``[name, start_ns, end_ns]`` in
    ``time.time_ns()``) and ``dropped``."""
    with _lock:
        merged = dict(_retired)
        for _, state in _threads:
            for name, st in list(state.stats.items()):
                merged[name] = _merge(merged.get(name, (0, 0, 0, [])), st.summary())
        counters = dict(_counters)
        timeline = [list(e) for e in _timeline]
        dropped = _dropped
    spans = {name: {"count": n, "total_s": total * 1e-9, "self_s": self_time * 1e-9,
                    "recent_s": [d * 1e-9 for d in recent]}
             for name, (n, total, self_time, recent) in merged.items()}
    return {"spans": spans, "counters": counters, "timeline": timeline, "dropped": dropped}
