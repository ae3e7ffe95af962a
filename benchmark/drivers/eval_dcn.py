"""Driver ``eval_dcn``: ``eval_throughput`` on a configuration with DCN
heads, held to the reference with DCN heads (``reference/mvster_dcn.py``).

``run`` and ``control`` are ``eval_throughput``'s, called with the DCN
``Net`` in the place of ``reference.mvster.Net`` (``compare.Net``) for the
call only. ``flops_per_iter`` adds the heads' FLOPs (``counts/dcn.py``),
which ``counts/roofline.py`` does not count.

A traced run then profiles ``profile_iters`` eager forwards
(``graphs.eager()``) of the same model on the pool's batches, after the
window and its check: a replayed graph shows no ranges inside it, and its
kernels are the eager forward's. ``res["dcn"]`` holds ``bound_ms``, the
heads' bound a forward, and with the profile ``heads_s``, the device
seconds of the kernels launched inside the program's ``mvster.dcn``
ranges (the span ``dcn`` of ``models/fpn.NADCN`` under a profiler),
``forward_s``, the device seconds of every kernel of those forwards, and
``iters``. A program without the span gives no ``heads_s``.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
from collections import defaultdict

import torch

from benchmark import compare, harness, program
from benchmark.counts import dcn
from benchmark.reference import mvster_dcn

BASE = harness.load_module(harness.find("drivers", "eval_throughput", ".py"))
RANGE = "mvster.dcn"
LAUNCHES = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def _dcn_reference():
    saved = compare.Net
    compare.Net = mvster_dcn.Net
    try:
        yield
    finally:
        compare.Net = saved


def run(ctx, fault=None):
    """``eval_throughput.run`` against the DCN reference (module docstring)."""
    with _dcn_reference():
        res = BASE.run(ctx, fault)
    mix = ctx.traffic
    heads = dcn.totals(dcn.heads(mix["batch"], mix["views"], mix["height"], mix["width"],
                                 ctx.config["fpn_base_channel"], ctx.config["dtype"]))
    res["flops_per_iter"] += heads["flops"]
    res["dcn"] = {"bound_ms": heads["bound_ms"]}
    if ctx.trace and torch.device(ctx.device).type == "cuda":
        res["dcn"].update(profile_heads(ctx))
    return res


def control(ctx, mode: str):
    """``eval_throughput.control`` against the DCN reference."""
    with _dcn_reference():
        return BASE.control(ctx, mode)


def profile_heads(ctx):
    """``heads_s``, ``forward_s`` and ``iters`` of ``profile_iters`` eager
    forwards on the pool's batches (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import setup_device
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    dev = setup_device(ctx.device)
    mix = ctx.traffic
    B, V, P = mix["batch"], mix["views"], mix["pool"]
    iters = ctx.spec["profile_iters"]
    model, _ = program.build_model(ctx.config, ctx.seed, dev)
    data = program.scenes(ctx, B * P, V)
    pool = [program.take(data, slice(i * B, (i + 1) * B)) for i in range(P)]
    forward = make_eval_forward(model)

    def step(i):
        b = pool[i % P]
        forward(b["imgs"], b["proj_matrices"], b["depth_values"])

    with graphs.eager():
        step(0)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                step(i)
            torch.cuda.synchronize(dev)
    harness.CACHE.mkdir(parents=True, exist_ok=True)
    path = harness.CACHE / "dcn_trace.json.gz"
    prof.export_chrome_trace(str(path))
    try:
        with gzip.open(path, "rt") as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return {**device_seconds(events), "iters": iters}


def device_seconds(events):
    """From a Chrome trace's events: ``forward_s``, the summed duration of
    every device operation, and, where the trace has ``mvster.dcn`` ranges,
    ``heads_s``, that of the operations launched (runtime or driver call
    on the same thread) inside one."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = defaultdict(list)          # by thread: (start, end), the ranges do not nest
    for e in xs:
        if e.get("name") == RANGE and e.get("cat") == "user_annotation":
            ranges[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    device = [e for e in xs if e.get("cat") in harness.DEVICE_EVENTS]
    out = {"forward_s": 1e-6 * sum(float(e["dur"]) for e in device)}
    if not ranges:
        return out
    for r in ranges.values():
        r.sort()

    def launched_inside(e):
        r = ranges.get(e["tid"], ())
        i = bisect.bisect_right(r, (float(e["ts"]), float("inf"))) - 1
        return i >= 0 and float(e["ts"]) <= r[i][1]

    inside = {e["args"]["correlation"] for e in xs
              if e.get("cat") in LAUNCHES and "correlation" in e.get("args", {})
              and launched_inside(e)}
    out["heads_s"] = 1e-6 * sum(float(e["dur"]) for e in device
                                if e.get("args", {}).get("correlation") in inside)
    return out
