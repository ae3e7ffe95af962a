"""Driver ``eval_throughput``: offline depth-map throughput of the captured
eval forward.

Set-up builds the network with the seed's weights, renders the traffic
mix's pool of ``pool`` distinct batches on the card and captures the
forward (``eval.depthgen.make_eval_forward``, one CUDA graph for the one
input signature). The window then runs the forward back to back through
the pool; the host runs ahead of the card by at most one pool (it waits for
the event of the forward one pool earlier before it enqueues the next), and
the window closes with one synchronise. ``eval_maps_per_s`` is the maps
of every forward enqueued in the window over the window's seconds, the
synchronise included.

A traced run profiles ``profile_iters`` forwards from the middle of the
window. After the window, the last output of ``check_batches`` pool slots
drawn from the seed (every stage's depths and the confidence) is held
against the plain reference (``compare.DepthGap``).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, harness, program
from benchmark.counts import roofline


def run(ctx, fault=None):
    """One run of the cell (``run.py``); ``fault`` (the benchmark's own
    tests) alters the program's outputs where they are produced."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import setup_device
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
    )

    dev = setup_device(ctx.device)
    mix, spec = ctx.traffic, ctx.spec
    B, V, P = mix["batch"], mix["views"], mix["pool"]
    model, weights = program.build_model(ctx.config, ctx.seed, dev)
    data = program.scenes(ctx, B * P, V)
    pool = [program.take(data, slice(i * B, (i + 1) * B)) for i in range(P)]
    forward = make_eval_forward(model)
    spans = harness.Spans()
    outs = [None] * P
    events = [None] * P
    n = 0

    def step():
        nonlocal n
        i = n % P
        if events[i] is not None:
            events[i].synchronize()
        b = pool[i]
        with spans("forward"):
            out = forward(b["imgs"], b["proj_matrices"], b["depth_values"])
        if fault is not None:
            out = fault(out)
        outs[i] = (out["stage_depths"], out["confidence"])
        if dev.type == "cuda":
            events[i] = torch.cuda.Event()
            events[i].record()
        n += 1

    step()                     # capture, then the first replay
    harness.sync(dev)
    n, outs[0] = 0, None
    spans = harness.Spans()
    win = harness.Window(ctx.seconds, dev)
    trace = {}
    win.open()
    setup_s = win.t0 - ctx.t_start
    while n < P or not win.done():
        if ctx.trace and not trace and time.perf_counter() - win.t0 >= ctx.seconds / 2:
            trace = harness.profile_stretch(step, spec["profile_iters"], spans, dev)
        else:
            step()
    elapsed = win.close()
    device = harness.device_info(dev)
    trace = harness.finish_trace(trace)

    rng = harness.seed_rng(ctx.seed, 3)
    slots = sorted(rng.choice(P, min(spec["check_batches"], P), replace=False).tolist())
    produced = {i: outs[i] for i in slots}
    del model, forward, outs, events
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gap = compare.DepthGap(**ctx.spec["sure"])
    for i in slots:
        ref = compare.reference_depths(weights, ctx.config, pool[i])
        gap.add(*produced[i], ref)
    numbers = gap.numbers()
    checks = compare.judge(numbers, spec["limits"])
    failed = gap.bad_maps
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)

    roof = roofline.totals(roofline.pieces(ctx.config, B, V, mix["height"], mix["width"]))
    kern = roofline.kernel_pieces(ctx.config, B, V, mix["height"], mix["width"], train=False)
    return {
        "e2e": {"eval_maps_per_s": n * B / elapsed, "setup_s": setup_s},
        "attempted": n * B, "failed": failed, "correct": correct, "checks": checks,
        "numbers": numbers, "check_s": time.perf_counter() - t_check,
        "device": device, "trace": trace, "spans": dict(spans.total),
        "iters": n, "window_s": elapsed, "dtype": ctx.config["dtype"],
        "flops_per_iter": roof["flops"], "kernel_pieces": kern,
    }


def control(ctx, mode: str):
    """The numbers of ``run``'s check with the reference at the control
    precision ``mode`` (``tf32`` or ``fp8``) put in the program's place, on
    the same seed's weights, pool and sampled slots."""
    mix, spec = ctx.traffic, ctx.spec
    B, V, P = mix["batch"], mix["views"], mix["pool"]
    _, weights = program.build_model(ctx.config, ctx.seed, ctx.device)
    data = program.scenes(ctx, B * P, V)
    rng = harness.seed_rng(ctx.seed, 3)
    slots = sorted(rng.choice(P, min(spec["check_batches"], P), replace=False).tolist())
    gap = compare.DepthGap(**ctx.spec["sure"])
    for i in slots:
        b = program.take(data, slice(i * B, (i + 1) * B))
        low = compare.reference_depths(weights, ctx.config, b, mode)
        ref = compare.reference_depths(weights, ctx.config, b)
        gap.add(low["stage_depths"], low["confidence"], ref)
    return gap.numbers()
