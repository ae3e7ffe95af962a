"""Driver ``scene_cloud``: scene-to-cloud latency of a calibrated rig, one
client in a closed loop, as the program's eval CLI runs a scene.

Set-up builds the network with the seed's weights and renders the traffic
mix's pool of ``pool`` scenes, then keeps them in host memory as the
loader would hand them over. A scene is timed from its images in host
memory to its cloud on the host:

1. each view as the reference against the other views
   (``eval.depthgen.run_forward``: pinned copies in, the captured forward,
   results to the host);
2. each view filtered against its sources and its points fused
   (``eval.scene_filter.fuse_view``, the filter captured on the card);
3. the views' points and colours joined on the host.

The next scene starts when the last ends. ``cloud_ms_p50`` is over
every scene of the window. The host spans
``forward`` (step 1) and ``fusion`` (steps 2 and 3) are summed per scene.
After the window, ``check_scenes`` pool scenes drawn from the seed are
checked: the program's depths of every stage and its confidence against
the reference's forward, and its fused depth and masks against the
reference's filter run on the program's own depth and confidence maps.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import compare, harness, program
from benchmark.reference import fusion as ref_fusion


def _host_scenes(ctx, P, V):
    data = program.scenes(ctx, P, V)
    return [{"imgs": data["imgs"][i].cpu().numpy(),
             "proj_matrices": {k: v[i].cpu().numpy() for k, v in data["proj_matrices"].items()},
             "depth_values": data["depth_values"][i].cpu().numpy()} for i in range(P)]


def _order(v, V):
    return [v] + [s for s in range(V) if s != v]


def _view_batch(scene, v, V):
    order = _order(v, V)
    return {"imgs": scene["imgs"][order][None],
            "proj_matrices": {k: p[order][None] for k, p in scene["proj_matrices"].items()},
            "depth_values": scene["depth_values"][None]}


def _cams(scene, V):
    stack = scene["proj_matrices"]["stage4"]
    return {v: (stack[v, 1, :3, :3], stack[v, 0]) for v in range(V)}


def run(ctx, fault=None):
    """One run of the cell (``run.py``); ``fault`` (the benchmark's own
    tests) alters the program's answers where they are produced."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import setup_device
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
        run_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.fusion import FusionConfig
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.scene_filter import (
        fuse_view,
    )

    dev = setup_device(ctx.device)
    mix, spec, fcfg = ctx.traffic, ctx.spec, ctx.config["fusion"]
    V, P = mix["views"], mix["pool"]
    n_src = fcfg["NviewFilter"] - 1
    cfg = FusionConfig(photomask=fcfg["photomask"], geomask=fcfg["geomask"],
                       condmask_pixel=fcfg["condmask_pixel"],
                       condmask_depth=fcfg["condmask_depth"])
    model, weights = program.build_model(ctx.config, ctx.seed, dev)
    scenes = _host_scenes(ctx, P, V)
    forward = make_eval_forward(model)
    spans = harness.Spans()
    kept = {}
    latencies = []
    n = 0
    order = harness.seed_rng(ctx.seed, 4).permutation(P)

    def scene_step():
        nonlocal n
        i = int(order[n % P])
        scene = scenes[i]
        t0 = time.perf_counter()
        depths, confs, stages = {}, {}, {}
        with spans("forward"):
            for v in range(V):
                out, _, _ = run_forward(forward, _view_batch(scene, v, V), dev)
                if fault is not None:
                    out = fault(out)
                depths[v], confs[v] = out["depth"][0], out["confidence"][0]
                stages[v] = [s[0] for s in out["stage_depths"]]
        with spans("fusion"):
            cams = _cams(scene, V)
            images = {v: scene["imgs"][v] for v in range(V)}
            views = {}
            for v in range(V):
                srcs = _order(v, V)[1:1 + n_src]
                views[v] = fuse_view(v, srcs, depths, confs, cams, images, cfg, device=dev)
            xyz = np.concatenate([views[v]["xyz"] for v in range(V)])
            rgb = np.concatenate([views[v]["rgb"] for v in range(V)])
        latencies.append(time.perf_counter() - t0)
        kept[i] = {"depths": depths, "confs": confs, "stages": stages, "views": views,
                   "cloud": (xyz, rgb)}
        n += 1

    scene_step()               # captures the forward and the filter
    n, latencies = 0, []
    spans = harness.Spans()
    win = harness.Window(ctx.seconds, dev)
    trace = {}
    win.open()
    setup_s = win.t0 - ctx.t_start
    while not win.done():
        if ctx.trace and not trace and time.perf_counter() - win.t0 >= ctx.seconds / 2:
            trace = harness.profile_stretch(scene_step, spec["profile_iters"], spans, dev)
        else:
            scene_step()
    elapsed = win.close()
    device = harness.device_info(dev)
    trace = harness.finish_trace(trace)

    rng = harness.seed_rng(ctx.seed, 3)
    done = sorted(kept)
    sample = sorted(rng.choice(done, min(spec["check_scenes"], len(done)),
                               replace=False).tolist())
    produced = {i: kept[i] for i in sample}
    del model, forward, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, failed = check(ctx, weights, scenes, produced, fcfg)
    checks = compare.judge(numbers, spec["limits"])
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    ms = np.asarray(latencies) * 1e3
    return {
        "e2e": {"cloud_ms_p50": float(np.percentile(ms, 50)), "setup_s": setup_s},
        "attempted": n, "failed": failed, "correct": correct, "checks": checks,
        "numbers": numbers, "check_s": time.perf_counter() - t_check,
        "device": device, "trace": trace, "spans": dict(spans.total), "requests": n,
        "window_s": elapsed,
    }


def check(ctx, weights, scenes, produced, fcfg):
    """``(numbers, failed)``: the sampled scenes' answers against the
    reference (module docstring)."""
    dev = torch.device(ctx.device)
    V = ctx.traffic["views"]
    n_src = fcfg["NviewFilter"] - 1
    gap = compare.DepthGap(**ctx.spec["sure"])
    fuse = compare.FusionGap()
    failed = 0
    for i, got in produced.items():
        scene = scenes[i]
        cams = {v: tuple(torch.as_tensor(a, device=dev) for a in c)
                for v, c in _cams(scene, V).items()}
        depth = {v: torch.as_tensor(got["depths"][v], device=dev) for v in range(V)}
        for v in range(V):
            b = {k: (torch.as_tensor(x, device=dev) if not isinstance(x, dict)
                     else {s: torch.as_tensor(y, device=dev) for s, y in x.items()})
                 for k, x in _view_batch(scene, v, V).items()}
            ref = compare.reference_depths(weights, ctx.config, b)
            gap.add([torch.as_tensor(s, device=dev)[None] for s in got["stages"][v]],
                    got["confs"][v], ref)
            srcs = _order(v, V)[1:1 + n_src]
            with torch.no_grad(), compare.precision("float32"):
                conf = torch.as_tensor(got["confs"][v], device=dev)
                want = ref_fusion.filter_view(depth[v], conf, cams[v],
                                              [(depth[s], cams[s]) for s in srcs], fcfg)
            fuse.add(got["views"][v], want)
        xyz, rgb = got["cloud"]
        n_pts = sum(int(np.asarray(got["views"][v]["final_mask"]).sum()) for v in range(V))
        failed += int(len(xyz) != n_pts or len(rgb) != n_pts or not np.isfinite(xyz).all())
    return {**gap.numbers(), **fuse.numbers()}, failed


def control(ctx, mode: str):
    """The check's numbers with the reference at the control precision
    ``mode`` in the program's place: its forward's depths and
    confidences, filtered and fused by the reference at that precision,
    against the float32 reference."""
    dev = torch.device(ctx.device)
    V, P = ctx.traffic["views"], ctx.traffic["pool"]
    fcfg = ctx.config["fusion"]
    n_src = fcfg["NviewFilter"] - 1
    _, weights = program.build_model(ctx.config, ctx.seed, dev)
    scenes = _host_scenes(ctx, P, V)
    rng = harness.seed_rng(ctx.seed, 3)
    sample = sorted(rng.choice(P, min(ctx.spec["check_scenes"], P), replace=False).tolist())
    produced = {}
    for i in sample:
        scene = scenes[i]
        cams = {v: tuple(torch.as_tensor(a, device=dev) for a in c)
                for v, c in _cams(scene, V).items()}
        depths, confs, stages, views = {}, {}, {}, {}
        for v in range(V):
            b = {k: (torch.as_tensor(x, device=dev) if not isinstance(x, dict)
                     else {s: torch.as_tensor(y, device=dev) for s, y in x.items()})
                 for k, x in _view_batch(scene, v, V).items()}
            low = compare.reference_depths(weights, ctx.config, b, mode)
            depths[v], confs[v] = low["depth"][0], low["confidence"][0]
            stages[v] = [s[0].cpu().numpy() for s in low["stage_depths"]]
        for v in range(V):
            srcs = _order(v, V)[1:1 + n_src]
            with torch.no_grad(), compare.precision(mode):
                out = ref_fusion.filter_view(depths[v], confs[v], cams[v],
                                             [(depths[s], cams[s]) for s in srcs], fcfg)
            views[v] = {k: out[k].cpu().numpy()
                        for k in ("photo_mask", "geo_mask", "final_mask", "fused_depth")}
        produced[i] = {"depths": {v: d.cpu().numpy() for v, d in depths.items()},
                       "confs": {v: c.cpu().numpy() for v, c in confs.items()},
                       "stages": stages, "views": views,
                       "cloud": (np.zeros((0, 3)), np.zeros((0, 3)))}
    numbers, _ = check(ctx, weights, scenes, produced, fcfg)
    return numbers
