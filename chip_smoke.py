#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per source,
   all started together) and prints the build seconds and ptxas's register
   and shared-memory report.
2. Holds each kernel against its plain PyTorch version at every shape the
   flagship forward gives it, in float32 (TF32 off) and in bf16, and times
   both with CUDA events.
3. Drives the flagship eval forward (the JAX package's ``_dtu_model()``
   config: FPN, reg2d, group correlation (8,8,4,4), inverse depth,
   attn_temp 2, bf16, mono) at B=4, V=4, 512x640 with seeded random weights
   and BatchNorm statistics on plane-scene inputs: the launch counters are
   set to 0 just before one forward and read just after (K1 12 launches,
   K2 3), then three rounds of five forwards are timed.
4. Checks the output: finite depth of the expected shape, and, on a small
   input, the card's forward against the CPU's plain forward with the same
   weights in float32.

Lines before the last: the card's name and power limit (``nvidia-smi``),
the build, a ``kernel_shapes`` line, a ``profile`` line (device time of
one forward by kernel), a ``forward`` line, a ``kernels`` line. The last
line is ``{"ok": true, "device": {...}}``; any failed check raises before
it, with a non-zero exit. Without CUDA it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
JAX_PKG_OPS = "deep_reconstruction_with_epipolar_lines_mvster_tpu/ops/pallas"

# H100 SXM data sheet: HBM bytes/s, dense bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

B, V, H, W = 4, 4, 512, 640
SEED = 0


def _dtu_model_config(dtype="bfloat16"):
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig

    return ModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
        mono=True, attn_temp=2.0, dtype=dtype, pack_conv=True,
        warp_impl="mxu_v3", warp_band=12, fused_topdown=True,
    )


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _scale(want):
    return max(1.0, want.float().abs().max().item())


def _randomize_batchnorm(model, gen):
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
        TorchBatchNorm,
    )

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)


def _make_model(cfg, device, seed):
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    gen = torch.Generator().manual_seed(seed)
    model = MVS4Net(cfg, device="cpu", generator=gen)
    _randomize_batchnorm(model, gen)
    return model.to(device)


def _scene(b, v, h, w, device):
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        batch_samples,
        batch_to_torch,
        make_plane_scene,
    )

    scenes = [make_plane_scene(V=v, H=h, W=w, seed=SEED + i) for i in range(b)]
    return batch_to_torch(batch_samples(scenes), device)


def check_kernels(dev, batch):
    """Each kernel against its plain version at the forward's shapes, in
    float32 and bf16; times in bf16 (the forward's dtype)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.hypothesis import (
        init_inverse_range,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_cor as k1,
    )

    cfg = _dtu_model_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def record(kernel, shape, dtype, err, tol, per_fwd, run, run_ref, nbytes, ops, peak):
        row = {
            "kernel": kernel, "shape": shape, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_diff": err, "tolerance": tol, "launches_per_forward": per_fwd,
        }
        if dtype == torch.bfloat16:
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
            row.update(
                kernel_ms=_time_ms(run, 20), plain_ms=_time_ms(run_ref, 3),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops,
            )
        if err > tol:
            raise AssertionError(f"{kernel} {shape} {dtype}: max|diff| {err} > {tol}")
        rows.append(row)

    for dtype in (torch.float32, torch.bfloat16):
        # K1 at each stage: C and G of the stage, D hypotheses, 3 source views
        for s in range(4):
            h, w = H >> (3 - s), W >> (3 - s)
            C, G, D = cfg.fpn_out_channels[s], cfg.group_cor_dim[s], cfg.ndepths[s]
            projs = batch["proj_matrices"][f"stage{s + 1}"]
            rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
            hypo = init_inverse_range(batch["depth_values"], D, h, w).float()
            hypo = (hypo * (1 + 0.01 * torch.randn(hypo.shape, generator=gen, device=dev))).contiguous()
            src = torch.randn((B, h, w, C), generator=gen, device=dev).to(dtype)
            ref = torch.randn((B, h, w, C), generator=gen, device=dev).to(dtype)
            args = (src, ref, rel, hypo, G)
            got, want = k1.warp_cor(*args), k1.warp_cor_ref(*args)
            torch.cuda.synchronize()
            out_bytes = got.numel() * got.element_size()
            nbytes = sum(t.numel() * t.element_size() for t in args[:4]) + out_bytes
            record("warp_cor", [B, D, h, w, C, G], dtype, _max_err(got, want),
                   k1.TOLERANCE[dtype] * _scale(want), V - 1,
                   lambda: k1.warp_cor(*args), lambda: k1.warp_cor_ref(*args),
                   nbytes, B * D * h * w * (28 + 9 * C + G), FP32_FLOPS)
        # K2 at each top-down level: (Cs, Co) = (32,32), (16,16), (8,8)
        N = B * V
        for lvl, (cs, co) in enumerate(((32, 32), (16, 16), (8, 8))):
            hh, wh = H >> (3 - lvl), W >> (3 - lvl)
            with_u = lvl < 2
            intra = torch.randn((N, hh, wh, 64), generator=gen, device=dev).to(dtype)
            skip = torch.randn((N, 2 * hh, 2 * wh, cs), generator=gen, device=dev).to(dtype)
            wi = torch.randn((64, cs, 1, 1), generator=gen, device=dev) * cs ** -0.5
            bi = torch.randn((64,), generator=gen, device=dev) * 0.1
            wo = torch.randn((co, 64, 3, 3), generator=gen, device=dev) * 576 ** -0.5
            args = (intra, skip, wi, bi, wo, with_u)
            got, want = k2.topdown_level(*args), k2.topdown_level_ref(*args)
            torch.cuda.synchronize()
            got, want = (got, want) if with_u else ((got,), (want,))
            err = max(_max_err(a, b) for a, b in zip(got, want))
            tol = k2.TOLERANCE[dtype] * max(_scale(b) for b in want)
            esz = intra.element_size()
            npix = N * 4 * hh * wh
            nbytes = (intra.numel() + skip.numel()) * esz + npix * (co + (64 if with_u else 0)) * esz \
                + (wi.numel() + bi.numel() + wo.numel()) * 4
            ops = npix * (64 * (2 * cs + 7) + 2 * 9 * 64 * co)
            record("topdown", [N, 2 * hh, 2 * wh, cs, co], dtype, err, tol, 1,
                   lambda: k2.topdown_level(*args), lambda: k2.topdown_level_ref(*args),
                   nbytes, ops, BF16_TENSOR_FLOPS)
    return rows


def check_small_forward_against_cpu(dev):
    """The card's float32 forward against the CPU's plain forward, same
    weights, on a 64x128 scene: attention within 1e-3 and depth equal at
    >= 99% of pixels per stage (argmax near-ties may flip)."""
    import torch

    cfg = _dtu_model_config("float32")
    cpu_model = _make_model(cfg, "cpu", SEED + 1)
    gpu_model = _make_model(cfg, dev, SEED + 1)
    b_cpu, b_gpu = _scene(1, 3, 64, 128, "cpu"), _scene(1, 3, 64, 128, dev)
    with torch.inference_mode():
        want = cpu_model(b_cpu["imgs"], b_cpu["proj_matrices"], b_cpu["depth_values"])
        got = gpu_model(b_gpu["imgs"], b_gpu["proj_matrices"], b_gpu["depth_values"])
    worst = {}
    for s in range(1, 5):
        g = {k: v.float().cpu() for k, v in got[f"stage{s}"].items()}
        w = want[f"stage{s}"]
        attn = (g["attn_weight"] - w["attn_weight"]).abs().max().item()
        same = torch.isclose(g["depth"], w["depth"], rtol=1e-5, atol=0).float().mean().item()
        if attn > 1e-3 or same < 0.99:
            raise AssertionError(f"stage{s}: attn diff {attn}, depth agreement {same}")
        worst[f"stage{s}"] = {"attn_max_abs_diff": attn, "depth_agreement": same}
    return worst


def profile_forward(model, args):
    """Device time of one forward by kernel, from ``torch.profiler``: the
    total, the device's busy share of the forward's wall time, the share of
    K1, K2 and the convolution library, and the ten largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    total = sum(ms for _, ms, _ in kernels)

    def share(pred):
        return sum(ms for k, ms, _ in kernels if pred(k.lower())) / total if total else 0.0

    is_conv = ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd", "wgrad", "dgrad")
    return {
        "device_ms": total, "wall_ms": wall_ms,
        "device_busy_share": total / wall_ms if wall_ms else 0.0,
        "share_warp_cor": share(lambda k: "warp_cor_kernel" in k),
        "share_topdown": share(lambda k: "topdown_kernel" in k),
        "share_conv_library": share(lambda k: any(c in k for c in is_conv)),
        "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                for k, ms, n in sorted(kernels, key=lambda x: -x[1])[:10]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to measure", file=sys.stderr)
        return 1
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_cor as k1,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}))

    t0 = time.perf_counter()
    built = _build.build(["warp_cor", "topdown"])
    build_s = time.perf_counter() - t0
    for name in ("warp_cor", "topdown"):
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(json.dumps({"build": {"wall_s": build_s,
                                **{k: v[0] for k, v in built.items()}}}))

    batch = _scene(B, V, H, W, dev)
    rows = check_kernels(dev, batch)
    print(json.dumps({"kernel_shapes": rows}))

    model = _make_model(_dtu_model_config(), dev, SEED)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    with torch.inference_mode():
        model(*args)                      # warm-up
        torch.cuda.synchronize()
        k1.launches = 0
        k2.launches = 0
        out = model(*args)                # the main path, counted
        torch.cuda.synchronize()
        counts = {"warp_cor": k1.launches, "topdown": k2.launches}
        if counts != {"warp_cor": 12, "topdown": 3}:
            raise AssertionError(f"launches per forward {counts}, want 12 and 3")
        depth = out["stage4"]["depth"]
        conf = out["stage4"]["photometric_confidence"]
        if tuple(depth.shape) != (B, H, W) or not torch.isfinite(depth).all():
            raise AssertionError(f"stage-4 depth {tuple(depth.shape)} not finite/shaped")
        # max/Σ of the raw scores is ±inf where the D scores cancel exactly
        # (random weights, bf16), in the JAX package as here: hold the share
        conf_finite = torch.isfinite(conf).float().mean().item()
        if conf_finite < 0.99:
            raise AssertionError(f"stage-4 confidence finite at {conf_finite:.4f} of pixels")
        # three rounds of five timed forwards: the median round is the
        # reading, the three show the spread within this call
        reps, rounds = 5, 3
        k1.launches = 0
        k2.launches = 0
        round_ms = [_time_ms(lambda: model(*args), reps) for _ in range(rounds)]
        fwd_ms = sorted(round_ms)[rounds // 2]
        calls = rounds * (reps + 1)
        if (k1.launches, k2.launches) != (12 * calls, 3 * calls):
            raise AssertionError(f"timed forwards launched {k1.launches}, {k2.launches}")
        torch.cuda.reset_peak_memory_stats()
        profile = profile_forward(model, args)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"profile": profile}))
    small = check_small_forward_against_cpu(dev)

    kernels = []
    for name, route, src, replaces in (
        ("warp_cor", "cuda", f"{PKG}/csrc/warp_cor.cu",
         f"{JAX_PKG_OPS}/warp_fwd_v3.py:438"),
        ("topdown", "cuda", f"{PKG}/csrc/topdown.cu",
         f"{JAX_PKG_OPS}/topdown_fused.py:317"),
    ):
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "kernel_ms" in r]
        per_fwd = {k: sum(r[k] * r["launches_per_forward"] for r in timed)
                   for k in ("kernel_ms", "plain_ms", "bound_ms", "bytes", "ops")}
        by_ops = per_fwd["ops"] / (FP32_FLOPS if name == "warp_cor" else BF16_TENSOR_FLOPS) * 1e3
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_diff"] for r in mine if r["dtype"] == "bfloat16"),
            "ms": per_fwd["kernel_ms"], "plain_ms": per_fwd["plain_ms"],
            "bound_ms": per_fwd["bound_ms"],
            "bound_by": "operations" if by_ops > per_fwd["bytes"] / HBM_BYTES_PER_S * 1e3 else "bytes",
            "library_ms": None,
        })
    print(json.dumps({"forward": {
        "B": B, "V": V, "H": H, "W": W, "dtype": "bfloat16",
        "ms_per_forward": fwd_ms, "depth_maps_per_s": B * 1e3 / fwd_ms,
        "ms_per_forward_rounds": round_ms,
        "launches_per_forward": counts, "timed_forwards": reps * rounds,
        "stage4_confidence_finite_share": conf_finite,
        "peak_memory_gb": peak_gb,
        "small_input_vs_cpu_float32": small,
    }}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
