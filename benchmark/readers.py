"""Reductions from a driver's result to per-layer metrics, shared by the
readers in ``metrics/``. A reader that finds nothing to read returns
``None`` and the metric is left out of the line."""

from __future__ import annotations

from typing import Dict, Optional

from .counts import classify, roofline


def mfu(res: Dict) -> Optional[float]:
    """Logical FLOPs of the profiled stretch's iterations over its seconds
    and the dtype's dense peak, in %. The stretch, not the whole traced
    window: starting and stopping the profiler costs the window seconds
    in which the card does nothing."""
    trace = res.get("trace") or {}
    if not trace.get("window_s"):
        return None
    rate = res["flops_per_iter"] * trace["iters"] / trace["window_s"]
    return 100.0 * rate / roofline.DENSE_FLOPS[res["dtype"]]


def kernel_roofline(res: Dict) -> Optional[float]:
    """The summed bound of the program's kernels' work an iteration over
    their summed device time an iteration in the profiled stretch, in %:
    the families of ``kernels/`` that name count pieces."""
    trace = res.get("trace") or {}
    if not trace.get("kernels"):
        return None
    fams = [f for f in classify.families() if f.get("pieces")]
    seconds = classify.by_family([(n, d) for n, _, d in trace["kernels"]], fams)
    time_s = sum(seconds[f["name"]] for f in fams) / trace["iters"]
    bound_s = sum(p["bound_ms"] for p in res["kernel_pieces"]
                  if any(p["name"].startswith(pre) for f in fams for pre in f["pieces"])) / 1e3
    if time_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / time_s


def device_idle(res: Dict) -> Optional[float]:
    """The share of the profiled stretch in which no operation ran on the
    card, in %."""
    trace = res.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def span_ms(res: Dict, name: str) -> Optional[float]:
    """Milliseconds of host span ``name`` a request, over the whole window."""
    total = res.get("spans", {}).get(name)
    if total is None or not res.get("requests"):
        return None
    return 1e3 * total / res["requests"]
