#!/usr/bin/env python3
"""Time the eval forward (or the train step, or the kernels) of two
checkouts of the port on one card, in turn.

    python ab_eval_forward.py --repo A=DIR --repo B=DIR [--order ABBA]
                              [--rounds 7] [--reps 5]
                              [--path eval|train|pipeline|kernels]

Each letter of ``--order`` runs that checkout in a process of its own, so
that two versions of the package never share an interpreter. A process
builds the flagship model in bf16 (the config of ``chip_smoke.py``'s eval
phase; seeded weights and BatchNorm statistics) for the eval and train
paths; its checkout builds its
kernels from its own sources at first use, during the warm-up. With
``--path eval`` (the default) it makes B=4 plane scenes of V=4 views at
512x640 and times forwards in eval; with ``--path train`` it makes B=6
scenes of V=5 views and times the DTU recipe's train step (``train/step``:
recipe loss, Adam lr 1e-3, wd 1e-4); with ``--path pipeline`` it builds the
eval pipeline's model instead (``checks.eval_dtu_config()``, the
scripts/eval_dtu.sh model in float32) and times its eval forward on one
reference view of V=4 at 512x640, the forward that the eval CLI runs per
view. Each path runs through its entry point, as a user calls it:
``eval.depthgen.make_eval_forward`` for the eval and pipeline paths, the
``TrainStep`` for the train path (captured CUDA graphs where the
checkout captures, eager where it does not). It warms up with two calls,
times ``--rounds`` rounds of ``--reps`` calls with CUDA events, and adds
the device time of one call under ``torch.profiler`` (which traces the
kernels of a replayed graph). It uses only what every version of the port
since the eval pipeline has: ``ModelConfig``, ``MVS4Net(cfg, device=,
generator=)``, ``data.synthetic``, ``eval.depthgen.make_eval_forward``,
``checks.RECIPE_LOSS``, ``checks.eval_dtu_config`` and ``train.step``.

With ``--path kernels`` a process times the kernels of its checkout row by
row, on the inputs and with the timers of ``chip_smoke.py``'s kernel rows
(that file is taken from the checkout this script lies in; its helpers
import the package, so they reach the process's checkout): the device time
of 20 launches captured in one CUDA graph, the median of ``--rounds``
replays (``rows``), and the same launches back to back from the host
(``eager``). K1 (``warp_cor``) at the eval forward's four stages on the
path's hypotheses (``eval``), on the full inverse range (``eval_
full_range``, and at FPN base 4 and 16: ``eval_base4/16``) and in float32
at one B1 pipeline view (``pipeline_float32``); K5 (``attn_fuse``) at the
eval forward's four stages (``eval``, bf16) and at one B1 pipeline view
(``pipeline_float32``); K6 (``band_conv``) in float32 at every 3x3 layer
of the B4 forward (``eval_float32``) and of one B1 pipeline view
(``pipeline_float32``); K4 (``warp_fwd``) at the train step's on the
path's (``train``) and the full range (``full_range``,
``train_base4/16``); K3 (``warp_bwd``) on the train path's. The
hypotheses' depths and windows come from the checkout's ``ModelConfig``.

Prints the card's name and power limit, one JSON line per process and a
last JSON line with, per checkout, the median round of each of its
processes (per kernel row for ``--path kernels``). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
H, W = 512, 640
SHAPES = {"eval": (4, 4), "train": (6, 5), "pipeline": (1, 4)}   # (B, V) of each path
PATHS = sorted(SHAPES) + ["kernels"]


def _chip_smoke():
    """``chip_smoke.py`` of the checkout this script lies in, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure_kernels(rounds: int) -> dict:
    """The kernels' rows of the process's checkout (module docstring):
    ms per launch on the device (``rows``) and from the host (``eager``)."""
    import importlib

    import torch

    smoke = _chip_smoke()
    k1, k3, k4, k5, k6 = (importlib.import_module(f"{PKG}.ops.kernels.{n}")
                          for n in ("warp_cor", "warp_bwd", "warp_fwd", "attn_fuse", "band_conv"))
    geometry = importlib.import_module(f"{PKG}.core.geometry")
    cfg = smoke.dtu_model_config()
    dev = torch.device("cuda")
    rows, eager = {}, {}

    def timed(key, fn):
        rows[key] = smoke._time_graph_ms(fn, 20, rounds)
        eager[key] = smoke._time_ms(fn, 20)

    def rel_of(batch, s):
        projs = batch["proj_matrices"][f"stage{s + 1}"]
        return geometry.relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()

    def stages(batch, base, hyps, gen):
        """(s, h, w, C, hypo) of the four stages on ``hyps``"""
        path = smoke._path_hypotheses(batch, cfg) if hyps == "path" else None
        for s in range(4):
            h, w = smoke.H >> (3 - s), smoke.W >> (3 - s)
            hypo = path[s] if hyps == "path" else smoke._jittered_hypo(
                batch["depth_values"], cfg.ndepths[s], h, w, gen)
            yield s, h, w, smoke._stage_channels(base, s), hypo

    eval_batch = smoke._scene(smoke.B, smoke.V, smoke.H, smoke.W, dev)
    train_batch = smoke._scene(smoke.TRAIN_B, smoke.TRAIN_V, smoke.H, smoke.W, dev)
    widths = [(b, g, "full_range", f"_base{b}") for b, g in smoke.OTHER_WIDTHS]
    with torch.no_grad():
        for name, batch, base, groups, hyps, dtype in (
            ("eval", eval_batch, 8, cfg.group_cor_dim, "path", torch.bfloat16),
            ("eval_full_range", eval_batch, 8, cfg.group_cor_dim, "full_range", torch.bfloat16),
            *((f"eval{sfx}", eval_batch, b, g, h, torch.bfloat16) for b, g, h, sfx in widths),
            ("pipeline_float32", smoke._scene(1, smoke.V, smoke.H, smoke.W, dev), 8, cfg.group_cor_dim,
             "path", torch.float32),
        ):
            gen = torch.Generator(device=dev).manual_seed(smoke.SEED + base)
            nb = batch["depth_values"].shape[0]
            for s, h, w, C, hypo in stages(batch, base, hyps, gen):
                src = torch.randn((nb, h, w, C), generator=gen, device=dev).to(dtype)
                ref = torch.randn((nb, h, w, C), generator=gen, device=dev).to(dtype)
                a = (src, ref, rel_of(batch, s), hypo, groups[s])
                timed(f"warp_cor {name} stage{s + 1}", lambda a=a: k1.warp_cor(*a))
        for name, base, hyps in (("train", 8, "path"), ("full_range", 8, "full_range"),
                                 *((f"train{sfx}", b, h) for b, _, h, sfx in widths)):
            gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 4 + base)
            for s, h, w, C, hypo in stages(train_batch, base, hyps, gen):
                nb, rel = smoke.TRAIN_B, rel_of(train_batch, s)
                src = torch.randn((nb, h, w, C), generator=gen, device=dev).to(torch.bfloat16)
                timed(f"warp_fwd {name} stage{s + 1}", lambda a=(src, rel, hypo): k4.warp_fwd(*a))
                if name == "train":
                    g = torch.randn((nb, hypo.shape[1], h, w, C), generator=gen,
                                    device=dev).to(torch.bfloat16)
                    a = (g, rel, hypo, (nb, h, w, C))
                    timed(f"warp_bwd train stage{s + 1}", lambda a=a: k3.warp_bwd(*a))
        for name, nb, dtype in (("eval", smoke.B, torch.bfloat16),
                                ("pipeline_float32", 1, torch.float32)):
            gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 5)
            for s in range(4):
                a = smoke._attn_fuse_args(dev, gen, nb, s, 8, cfg.group_cor_dim, dtype)
                timed(f"attn_fuse {name} stage{s + 1}", lambda a=a: k5.attn_fuse(*a))
        for name, nb in (("eval_float32", smoke.B), ("pipeline_float32", 1)):
            gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
            for layer, n, h, w, ci, co, _ in smoke._band_conv_layers(nb):
                a = smoke._band_conv_args(dev, gen, n, h, w, ci, co, torch.float32)[0]
                timed(f"band_conv {name} {layer}", lambda a=a: k6.band_conv(*a))
    return {"rows": rows, "eager": eager}


def measure(repo: str, rounds: int, reps: int, path: str) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    config = importlib.import_module(f"{PKG}.config")
    models = importlib.import_module(f"{PKG}.models")
    layers = importlib.import_module(f"{PKG}.models.layers")
    synthetic = importlib.import_module(f"{PKG}.data.synthetic")
    if not os.path.abspath(models.__file__).startswith(os.path.abspath(repo)):
        raise RuntimeError(f"imported {models.__file__}, not the checkout at {repo}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if path == "kernels":
        return {"repo": repo, "path": path, **measure_kernels(rounds)}
    if path == "pipeline":
        cfg = importlib.import_module(f"{PKG}.checks").eval_dtu_config()
    else:
        cfg = config.ModelConfig(
            group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True, mono=True,
            attn_temp=2.0, dtype="bfloat16", pack_conv=True, warp_impl="mxu_v3",
            warp_band=12, fused_topdown=True,
        )
    gen = torch.Generator().manual_seed(0)
    model = models.MVS4Net(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.TorchBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
    model = model.to("cuda")
    B, V = SHAPES[path]
    scenes = [synthetic.make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)]
    batch = synthetic.batch_to_torch(synthetic.batch_samples(scenes), "cuda")
    if path in ("eval", "pipeline"):
        forward = importlib.import_module(f"{PKG}.eval.depthgen").make_eval_forward(model)
        args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])

        def call():
            forward(*args)
    else:
        checks = importlib.import_module(f"{PKG}.checks")
        step = importlib.import_module(f"{PKG}.train.step")
        train_step = step.make_train_step(model, checks.RECIPE_LOSS,
                                          step.make_optimizer(model, 1e-4), lambda i: 1e-3)

        def call():
            train_step(batch)

    round_ms = []
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        round_ms.append(start.elapsed_time(end) / reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e3
    return {"repo": repo, "path": path, "round_ms": round_ms,
            "median_ms": sorted(round_ms)[rounds // 2], "device_ms_one_call": device_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", action="append", default=[], help="LETTER=DIR")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--path", choices=PATHS, default="eval")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(measure(a.worker, a.rounds, a.reps, a.path)))
        return 0

    repos = dict(r.split("=", 1) for r in a.repo)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    medians = {k: {} if a.path == "kernels" else [] for k in repos}
    for letter in a.order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", repos[letter],
             "--rounds", str(a.rounds), "--reps", str(a.reps), "--path", a.path],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"{letter} ({repos[letter]}) exited {res.returncode}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": letter, **row}), flush=True)
        if a.path == "kernels":
            for key, ms in row["rows"].items():
                medians[letter].setdefault(key, []).append(ms)
        else:
            medians[letter].append(row["median_ms"])
    print(json.dumps({"path": a.path, "order": a.order, "median_ms_per_process": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
