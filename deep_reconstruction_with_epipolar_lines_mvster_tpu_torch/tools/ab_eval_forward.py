#!/usr/bin/env python3
"""Time the eval forward of two checkouts of the port on one card, in turn.

    python ab_eval_forward.py --repo A=DIR --repo B=DIR [--order ABBA]
                              [--rounds 7] [--reps 5]

Each letter of ``--order`` runs that checkout's forward in a process of its
own, so that two versions of the package never share an interpreter. A
process builds K1 and K2 from its checkout's sources, builds the flagship
model in bf16 (the config of ``chip_smoke.py``'s eval phase; seeded weights
and BatchNorm statistics), makes B=4 plane scenes of V=4 views at 512x640,
warms up with two forwards, times ``--rounds`` rounds of ``--reps``
forwards with CUDA events, and adds the device time of one forward under
``torch.profiler``. It uses only what every version of the port has:
``ModelConfig``, ``MVS4Net(cfg, device=, generator=)``, ``data.synthetic``
and ``ops._build.build``.

Prints the card's name and power limit, one JSON line per process and a
last JSON line with, per checkout, the median round of each of its
processes. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
B, V, H, W = 4, 4, 512, 640


def measure(repo: str, rounds: int, reps: int) -> dict:
    sys.path.insert(0, os.path.abspath(repo))
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    config = importlib.import_module(f"{PKG}.config")
    models = importlib.import_module(f"{PKG}.models")
    layers = importlib.import_module(f"{PKG}.models.layers")
    synthetic = importlib.import_module(f"{PKG}.data.synthetic")
    build = importlib.import_module(f"{PKG}.ops._build")
    if not os.path.abspath(models.__file__).startswith(os.path.abspath(repo)):
        raise RuntimeError(f"imported {models.__file__}, not the checkout at {repo}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["warp_cor", "topdown"])
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
    model = model.to("cuda").eval()
    scenes = [synthetic.make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)]
    batch = synthetic.batch_to_torch(synthetic.batch_samples(scenes), "cuda")
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])

    round_ms = []
    with torch.inference_mode():
        for _ in range(2):
            model(*args)
        torch.cuda.synchronize()
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                model(*args)
            end.record()
            end.synchronize()
            round_ms.append(start.elapsed_time(end) / reps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(*args)
            torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e3
    return {"repo": repo, "round_ms": round_ms, "median_ms": sorted(round_ms)[rounds // 2],
            "device_ms_one_forward": device_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", action="append", default=[], help="LETTER=DIR")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(measure(a.worker, a.rounds, a.reps)))
        return 0

    repos = dict(r.split("=", 1) for r in a.repo)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    medians = {k: [] for k in repos}
    for letter in a.order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", repos[letter],
             "--rounds", str(a.rounds), "--reps", str(a.reps)],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"{letter} ({repos[letter]}) exited {res.returncode}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": letter, **row}), flush=True)
        medians[letter].append(row["median_ms"])
    print(json.dumps({"order": a.order, "median_ms_per_process": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
