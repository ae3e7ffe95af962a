#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per source,
   all started together) and prints the build seconds and ptxas's register
   and shared-memory report.
2. Holds each kernel against its plain PyTorch version at every shape the
   flagship paths give it, in float32 (TF32 off) and in bf16, and times
   both with CUDA events: K1 and K2 at the eval forward's shapes, K3 (the
   warp backward) at the train step's, beside its library yardstick
   ``aten.grid_sampler_2d_backward``.
3. Drives the flagship eval forward (the JAX package's ``_dtu_model()``
   config: FPN, reg2d, group correlation (8,8,4,4), inverse depth,
   attn_temp 2, bf16, mono) at B=4, V=4, 512x640 with seeded random weights
   and BatchNorm statistics on plane-scene inputs: the launch counters are
   set to 0 just before one forward and read just after (K1 12 launches,
   K2 3), then three rounds of five forwards are timed.
4. Checks the eval output: finite depth of the expected shape, and, on a
   small input, the card's forward against the CPU's plain forward with the
   same weights in float32.
5. The top-down chain's ``autograd.Function`` (K2 forward, K2 re-deriving
   ``u`` in the backward) against autograd through the plain chain, at the
   train shape (30 images), in float32 and bf16 (``checks.py``).
6. A small float32 train step on the card against the same step on the
   CPU (B=2, V=3, 64x128; ``checks.check_train_step``): the card takes the
   CPU's next-stage hypotheses and its gradients at the cost volumes and
   mono depths, then the loss, the FPN outputs' gradients, every
   parameter's gradient, and a nonzero gradient for every parameter on the
   card are held to fixed limits.
7. Drives the DTU train recipe (B=6, V=5, 512x640, bf16, recipe loss,
   Adam lr 1e-3 wd 1e-4) on plane scenes: the counters are set to 0 just
   before one step and read just after (K3 16, K2 6, K1 0), then a warm-up
   step and three rounds of three timed steps, and a profile of one step.

Lines before the last: the card's name and power limit (``nvidia-smi``),
the build, a ``kernel_shapes`` line, a ``profile`` line (device time of
one forward by kernel), a ``forward`` line, a ``chain_backward`` line, a
``small_train_step`` line, a ``train`` line, a ``train_profile`` line and a
``kernels`` line. The last line is ``{"ok": true, "device": {...}}``; any
failed check raises before it, with a non-zero exit. Without CUDA it exits
non-zero and prints no result.
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
TRAIN_B, TRAIN_V = 6, 5             # the DTU recipe (scripts/train_dtu.sh)
SEED = 0
KERNELS = ("warp_cor", "topdown", "warp_bwd")


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


def _record(rows, kernel, path, shape, dtype, err, tol, per_run, run, run_ref, nbytes, ops,
            peak, run_library=None):
    """One ``kernel_shapes`` row: the kernel against its plain version, and
    in bf16 (the paths' dtype) their times, the bound and the library
    yardstick's time. Raises when the difference exceeds the tolerance."""
    import torch

    row = {
        "kernel": kernel, "path": path, "shape": shape,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_diff": err, "tolerance": tol, "launches_per_run": per_run,
    }
    if dtype == torch.bfloat16:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        row.update(
            kernel_ms=_time_ms(run, 20), plain_ms=_time_ms(run_ref, 3),
            library_ms=None if run_library is None else _time_ms(run_library, 20),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, ops=ops,
        )
    if err > tol:
        raise AssertionError(f"{kernel} {shape} {dtype}: max|diff| {err} > {tol}")
    rows.append(row)


def _jittered_hypo(depth_values, D, h, w, gen):
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.hypothesis import (
        init_inverse_range,
    )

    hypo = init_inverse_range(depth_values, D, h, w).float()
    noise = torch.randn(hypo.shape, generator=gen, device=hypo.device)
    return (hypo * (1 + 0.01 * noise)).contiguous()


def check_kernels(dev, batch):
    """K1 and K2 against their plain versions at the eval forward's shapes,
    in float32 and bf16; times in bf16 (the forward's dtype)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
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
    for dtype in (torch.float32, torch.bfloat16):
        # K1 at each stage: C and G of the stage, D hypotheses, 3 source views
        for s in range(4):
            h, w = H >> (3 - s), W >> (3 - s)
            C, G, D = cfg.fpn_out_channels[s], cfg.group_cor_dim[s], cfg.ndepths[s]
            projs = batch["proj_matrices"][f"stage{s + 1}"]
            rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
            hypo = _jittered_hypo(batch["depth_values"], D, h, w, gen)
            src = torch.randn((B, h, w, C), generator=gen, device=dev).to(dtype)
            ref = torch.randn((B, h, w, C), generator=gen, device=dev).to(dtype)
            args = (src, ref, rel, hypo, G)
            got, want = k1.warp_cor(*args), k1.warp_cor_ref(*args)
            torch.cuda.synchronize()
            out_bytes = got.numel() * got.element_size()
            nbytes = sum(t.numel() * t.element_size() for t in args[:4]) + out_bytes
            _record(rows, "warp_cor", "eval", [B, D, h, w, C, G], dtype, _max_err(got, want),
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
            _record(rows, "topdown", "eval", [N, 2 * hh, 2 * wh, cs, co], dtype, err, tol, 1,
                    lambda: k2.topdown_level(*args), lambda: k2.topdown_level_ref(*args),
                    nbytes, ops, BF16_TENSOR_FLOPS)
    return rows


def check_warp_bwd(dev, batch):
    """K3 against ``warp_bwd_ref`` at the train step's four stages (B=6,
    the stage's C and D, 4 source views each), with g in float32 and bf16;
    in bf16 the times of the kernel, the plain version and the library
    yardstick ``aten.grid_sampler_2d_backward`` (bilinear, zeros,
    align_corners, the D planes stacked as rows). The yardstick runs in
    float32: grid_sampler takes its grid in the input's dtype, and a bf16
    grid cannot hold a 640-pixel coordinate."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
        warp_coords,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_bwd as k3,
    )

    cfg = _dtu_model_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, library_diff = [], {}
    Bt = TRAIN_B
    for dtype in (torch.float32, torch.bfloat16):
        for s in range(4):
            h, w = H >> (3 - s), W >> (3 - s)
            C, D = cfg.fpn_out_channels[s], cfg.ndepths[s]
            projs = batch["proj_matrices"][f"stage{s + 1}"]
            rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
            hypo = _jittered_hypo(batch["depth_values"], D, h, w, gen)
            g = torch.randn((Bt, D, h, w, C), generator=gen, device=dev).to(dtype)
            shape = (Bt, h, w, C)
            got, want = k3.warp_bwd(g, rel, hypo, shape), k3.warp_bwd_ref(g, rel, hypo, shape)
            torch.cuda.synchronize()
            run_library = None
            if dtype == torch.bfloat16:
                xy = warp_coords(rel, hypo).reshape(Bt, D * h, w, 2)
                grid = torch.stack([xy[..., 0] * (2.0 / (w - 1)) - 1.0,
                                    xy[..., 1] * (2.0 / (h - 1)) - 1.0], dim=-1)
                g_nchw = g.float().permute(0, 4, 1, 2, 3).reshape(Bt, C, D * h, w).contiguous()
                src = torch.zeros((Bt, C, h, w), device=dev)

                def run_library(g_nchw=g_nchw, src=src, grid=grid):
                    return torch.ops.aten.grid_sampler_2d_backward(
                        g_nchw, src, grid, 0, 0, True, [True, False])[0]

                lib = run_library().permute(0, 2, 3, 1)
                library_diff[f"stage{s + 1}"] = _max_err(lib, want)
            # the function's bytes: g, hypo and rel read once, dsrc written
            # once; the zeroing pass of the atomic design is not in the bound
            nbytes = g.numel() * g.element_size() + hypo.numel() * 4 + rel.numel() * 4 \
                + got.numel() * 4
            _record(rows, "warp_bwd", "train", [Bt, D, h, w, C], dtype, _max_err(got, want),
                    k3.TOLERANCE[dtype] * _scale(want), TRAIN_V - 1,
                    lambda g=g, rel=rel, hypo=hypo, shape=shape: k3.warp_bwd(g, rel, hypo, shape),
                    lambda g=g, rel=rel, hypo=hypo, shape=shape: k3.warp_bwd_ref(g, rel, hypo, shape),
                    nbytes, Bt * D * h * w * (28 + 8 * C), FP32_FLOPS, run_library)
    return rows, library_diff


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


def profile_run(fn, shares):
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``:
    the total, the device's busy share of the call's wall time, the share
    of each ``shares`` entry (kernel names that contain one of its
    substrings) and the ten largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    total = sum(ms for _, ms, _ in kernels)

    def share(subs):
        hit = sum(ms for k, ms, _ in kernels if any(c in k.lower() for c in subs))
        return hit / total if total else 0.0

    return {
        "device_ms": total, "wall_ms": wall_ms,
        "device_busy_share": total / wall_ms if wall_ms else 0.0,
        **{f"share_{name}": share(subs) for name, subs in shares.items()},
        "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                for k, ms, n in sorted(kernels, key=lambda x: -x[1])[:10]],
    }


CONV_LIBRARY = ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd", "wgrad", "dgrad",
                "sm90_", "cutlass")


def check_chain_backward(dev):
    """The top-down chain's ``autograd.Function`` against autograd through
    the plain chain (``checks.check_chain_backward``, tolerances there) at
    the train shape (N = 6 x 5 images, intra 64x80 -> 512x640), in float32
    (TF32 off) and bf16, with the bf16 times of forward + backward."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves, grads = checks.chain_inputs(TRAIN_B * TRAIN_V, H >> 3, W >> 3, dtype, dev, gen)
        entry = checks.check_chain_backward(leaves, grads)
        if dtype == torch.bfloat16:
            before = k2.launches
            entry["function_fwd_bwd_ms"] = _time_ms(
                lambda: checks.chain_function_grads(leaves, grads), 3)
            entry["k2_launches_per_fwd_bwd"] = (k2.launches - before) // 4
            entry["plain_fwd_bwd_ms"] = _time_ms(
                lambda: checks.chain_plain_grads(leaves, grads), 3)
        out[str(dtype).replace("torch.", "")] = entry
    return out


def drive_train(dev, batch, counters):
    """The DTU train recipe at full width: counted step, warm-up, three
    rounds of three timed steps, a profile of one step."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )

    model = MVS4Net(_dtu_model_config(), device=dev,
                    generator=torch.Generator().manual_seed(SEED + 5))
    step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.launches = 0
    losses = [step(batch)["loss"].item()]            # the main path, counted
    counts = {name: mod.launches for name, mod in counters.items()}
    if counts != {"warp_cor": 0, "topdown": 6, "warp_bwd": 16}:
        raise AssertionError(f"launches per train step {counts}, want K1 0, K2 6, K3 16")
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: gradient missing or not finite")
    losses.append(step(batch)["loss"].item())        # warm-up
    reps, rounds = 3, 3
    round_ms, timed = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = [step(batch)["loss"] for _ in range(reps)]
        end.record()
        end.synchronize()
        round_ms.append(start.elapsed_time(end) / reps)
        timed += [x.item() for x in out]
    losses += timed
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sorted(round_ms)[rounds // 2]
    prof = profile_run(lambda: step(batch), {
        "warp_bwd": ("warp_bwd_kernel",), "topdown": ("topdown_kernel",),
        "warp_cor": ("warp_cor_kernel",), "conv_library": CONV_LIBRARY})
    train = {
        "B": TRAIN_B, "V": TRAIN_V, "H": H, "W": W, "dtype": "bfloat16",
        "ms_per_step": ms, "ms_per_step_rounds": round_ms, "samples_per_s": TRAIN_B * 1e3 / ms,
        "loss_per_step": losses, "launches_per_step": counts, "timed_steps": reps * rounds,
        "peak_memory_gb": peak_gb,
    }
    return train, prof, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to measure", file=sys.stderr)
        return 1
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_bwd as k3,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_cor as k1,
    )

    counters = {"warp_cor": k1, "topdown": k2, "warp_bwd": k3}
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
    built = _build.build(KERNELS)
    build_s = time.perf_counter() - t0
    for name in KERNELS:
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(json.dumps({"build": {"wall_s": build_s,
                                **{k: v[0] for k, v in built.items()}}}))

    batch = _scene(B, V, H, W, dev)
    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    rows = check_kernels(dev, batch)
    k3_rows, library_diff = check_warp_bwd(dev, train_batch)
    rows += k3_rows
    print(json.dumps({"kernel_shapes": rows,
                      "warp_bwd_library_max_abs_diff": library_diff}))

    model = _make_model(_dtu_model_config(), dev, SEED)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    with torch.inference_mode():
        model(*args)                      # warm-up
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        out = model(*args)                # the main path, counted
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
        if counts != {"warp_cor": 12, "topdown": 3, "warp_bwd": 0}:
            raise AssertionError(f"launches per forward {counts}, want K1 12, K2 3, K3 0")
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
        profile = profile_run(lambda: model(*args), {
            "warp_cor": ("warp_cor_kernel",), "topdown": ("topdown_kernel",),
            "conv_library": CONV_LIBRARY})
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"profile": profile}))
    small = check_small_forward_against_cpu(dev)
    print(json.dumps({"forward": {
        "B": B, "V": V, "H": H, "W": W, "dtype": "bfloat16",
        "ms_per_forward": fwd_ms, "depth_maps_per_s": B * 1e3 / fwd_ms,
        "ms_per_forward_rounds": round_ms,
        "launches_per_forward": counts, "timed_forwards": reps * rounds,
        "stage4_confidence_finite_share": conf_finite,
        "peak_memory_gb": peak_gb,
        "small_input_vs_cpu_float32": small,
    }}))
    del model, out, batch, args
    torch.cuda.empty_cache()

    print(json.dumps({"chain_backward": check_chain_backward(dev)}))
    torch.cuda.empty_cache()
    print(json.dumps({"small_train_step": checks.check_train_step(dev)}))
    train, train_profile, train_counts = drive_train(dev, train_batch, counters)
    print(json.dumps({"train": train}))
    print(json.dumps({"train_profile": train_profile}))

    kernels = []
    for name, route, src, replaces, path in (
        ("warp_cor", "cuda", f"{PKG}/csrc/warp_cor.cu",
         f"{JAX_PKG_OPS}/warp_fwd_v3.py:438", "eval"),
        ("topdown", "cuda", f"{PKG}/csrc/topdown.cu",
         f"{JAX_PKG_OPS}/topdown_fused.py:317", "eval"),
        ("warp_bwd", "cuda", f"{PKG}/csrc/warp_bwd.cu",
         f"{JAX_PKG_OPS}/warp_xband_bwd.py:410", "train"),
    ):
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "kernel_ms" in r]
        # per run of the kernel's timed path: an eval forward or a train step
        per_run = {k: sum(r[k] * r["launches_per_run"] for r in timed)
                   for k in ("kernel_ms", "plain_ms", "bound_ms", "bytes", "ops")}
        lib = [r["library_ms"] for r in timed]
        peak = BF16_TENSOR_FLOPS if name == "topdown" else FP32_FLOPS
        by_ops = per_run["ops"] / peak * 1e3
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": counts[name] + train_counts[name],
            "launches_eval": counts[name], "launches_train": train_counts[name],
            "timed_per": "eval forward" if path == "eval" else "train step",
            "max_abs_err": max(r["max_abs_diff"] for r in mine if r["dtype"] == "bfloat16"),
            "ms": per_run["kernel_ms"], "plain_ms": per_run["plain_ms"],
            "bound_ms": per_run["bound_ms"],
            "bound_by": "operations" if by_ops > per_run["bytes"] / HBM_BYTES_PER_S * 1e3 else "bytes",
            "library_ms": None if None in lib else sum(
                r["library_ms"] * r["launches_per_run"] for r in timed),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
