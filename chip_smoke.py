#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the port's six CUDA kernels from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints the build seconds and ptxas's
   register and shared-memory report.
2. Holds each kernel against its plain PyTorch version at every shape the
   flagship paths give it, in float32 (TF32 off) and in bf16, and times
   both with CUDA events: K1 (warp + group correlation), K5 (attention
   accumulation) and K6 (3x3 conv + folded BatchNorm + ReLU, beside
   ``F.conv2d`` + ``relu_`` on the folded weights and the unfused conv +
   BatchNorm + ReLU it replaces; also at two wider stem layers off its
   route) at the eval forward's shapes; K2 (FPN top-down level) at the eval
   forward's, the train step's (its 3 forward launches and the backward's 3
   ``u_only`` launches, N = 30) and, in float32, one pipeline view's; K3
   (warp backward) at the train step's on two sets of hypotheses (the full
   inverse range at every stage, as PR 4 timed it, and the train path's
   windows around a depth map), and K4 (warp forward) at the train step's,
   beside their library
   yardsticks ``aten.grid_sampler_2d_backward`` and ``F.grid_sample``.
3. Drives the flagship eval forward (the JAX package's ``_dtu_model()``
   config: FPN, reg2d, group correlation (8,8,4,4), inverse depth,
   attn_temp 2, bf16, mono) at B=4, V=4, 512x640 with seeded random weights
   and BatchNorm statistics on plane-scene inputs: the launch counters are
   set to 0 just before one forward and read just after (K1 12 launches,
   K2 3, K5 4, K6 8), then three rounds of five forwards are timed.
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
   before one step and read just after (K4 16, K3 16, K2 6, K6 0), then a
   warm-up step and three rounds of three timed steps, and a profile of one
   step.
8. Drives the eval pipeline of the eval CLI at full width
   (``checks.run_pipeline``: the scripts/eval_dtu.sh model in float32, B=1,
   a 4-view 512x640 plane scene with 192 hypotheses): the depth maps of
   every reference view, each view filtered against its 3 sources, the
   fused PLY written under ``chiprun_out/``; the counters are set to 0 just
   before the run and read just after (per view K1 12, K2 3, K5 4, K6 8),
   and a profile of one more run. Then the same pipeline at 64x128 on the
   card against the CPU (``checks.check_pipeline``).
9. Drives the train CLI (``cli.train.main`` in this process) at full width
   with scripts/train_dtu.sh's model, loss and optimizer flags on 12
   synthetic 512x640 scenes of 5 views, B=6, logdir ``chiprun_out/
   train_cli``: one epoch (2 steps, 2 validation batches, ``model_00.ckpt``),
   ``--resume --epochs 2`` (continues at epoch 2, step 2), ``--mode test``
   and ``--mode profile`` (a Chrome trace); the counters are set to 0 before
   each part and read after it (per train step K4 16, K3 16, K2 6, K6 0; per
   validation batch K1 16, K2 3, K5 4, K6 8).

Lines before the last: the card's name and power limit (``nvidia-smi``),
the build, a ``kernel_shapes`` line, a ``profile`` line (device time of
one forward by kernel), a ``forward`` line, a ``chain_backward`` line, a
``small_train_step`` line, a ``train`` line, a ``train_profile`` line, a
``pipeline_profile`` line, a ``pipeline`` line, a ``train_cli`` line and a
``kernels`` line. The last line is ``{"ok": true, "device": {...}}``; any
failed check raises before it, with a non-zero exit. Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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
# launches of each kernel on each path: an eval forward (B4 V4), a train
# step (B6 V5), one reference view of the eval pipeline (V4) and one
# validation batch of the train CLI (B6 V5)
EVAL_LAUNCHES = {"warp_cor": 12, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0, "attn_fuse": 4,
                 "band_conv": 8}
TRAIN_LAUNCHES = {"warp_cor": 0, "topdown": 6, "warp_bwd": 16, "warp_fwd": 16, "attn_fuse": 0,
                  "band_conv": 0}
PIPELINE_LAUNCHES_PER_VIEW = {"warp_cor": 12, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0,
                              "attn_fuse": 4, "band_conv": 8}
VAL_LAUNCHES = {"warp_cor": 16, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0, "attn_fuse": 4,
                "band_conv": 8}
PIPELINE_V = 4
# the weight seed of the pipeline phase: with random weights the fused cloud's
# size depends on the draw, and some seeds give an empty cloud; seed 4 gives
# a cloud of thousands of points at 512x640 (the `pipeline` line prints it)
PIPELINE_SEED = 4
PIPELINE_PLY = "chiprun_out/pipeline_fused.ply"
TRAIN_CLI_LOGDIR = "chiprun_out/train_cli"
# the train CLI phase: scripts/train_dtu.sh's model, loss and optimizer flags
# on 12 synthetic 512x640 plane scenes of 5 views, B6: 2 steps and 2
# validation batches an epoch
TRAIN_CLI_FLAGS = [
    "--bf16", "--mono", "--l1ce_lw", "0.003,1", "--wd", "1e-4", "--lr", "1e-3",
    "--group_cor", "--group_cor_dim", "8,8,4,4", "--ndepths", "8,8,4,4",
    "--depth_inter_r", "0.5,0.5,0.5,1", "--inverse_depth", "--attn_temp", "2", "--rt",
    "--seed", "0", "--dataset", "synthetic", "--trainpath", f"synthetic://{H}x{W}/12",
    "--batch_size", str(TRAIN_B), "--train_nviews", str(TRAIN_V), "--test_nviews", str(TRAIN_V),
    "--summary_freq", "1", "--logdir", TRAIN_CLI_LOGDIR,
]
# train steps of --mode profile: the first call, one warm-up, five timed
# (train/profiler.profile_step_fn) and one traced
PROFILE_STEPS = 8
# K6 at the eval forward's layers (B4 V4 512x640: N = B*V in the FPN stem,
# B*D in Reg2D.conv0 with D = 8, 8, 4, 4): (name, N, H, W, Ci, Co, launches
# per forward); conv1.1 and conv1.2 share a shape. The 32- and 64-channel
# stem layers are off the route (launches 0), timed so that the record says
# whether it should widen.
BAND_CONV_LAYERS = (
    ("stem conv0.0", B * V, H, W, 3, 8, 1),
    ("stem conv0.1", B * V, H, W, 8, 8, 1),
    ("stem conv1.1, conv1.2", B * V, H // 2, W // 2, 16, 16, 2),
    ("Reg2D.conv0 stage1", B * 8, H // 8, W // 8, 8, 8, 1),
    ("Reg2D.conv0 stage2", B * 8, H // 4, W // 4, 8, 8, 1),
    ("Reg2D.conv0 stage3", B * 4, H // 2, W // 2, 4, 8, 1),
    ("Reg2D.conv0 stage4", B * 4, H, W, 4, 8, 1),
    ("stem conv2.1 (off route)", B * V, H // 4, W // 4, 32, 32, 0),
    ("stem conv3.1 (off route)", B * V, H // 8, W // 8, 64, 64, 0),
)


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


def _scene(b, v, h, w, device):
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        batch_samples,
        batch_to_torch,
        make_plane_scene,
    )

    scenes = [make_plane_scene(V=v, H=h, W=w, seed=SEED + i) for i in range(b)]
    return batch_to_torch(batch_samples(scenes), device)


def _record(rows, kernel, path, shape, dtype, err, tol, per_run, run, run_ref, nbytes, ops,
            peak, run_library=None, run_unfused=None, row_set=None, timed=None, **extra):
    """One ``kernel_shapes`` row: the kernel against its plain version, and,
    when ``timed`` (by default in bf16, the paths' dtype), their times, the
    bound, the library yardstick's time and, where given, the time of the
    unfused route the kernel replaces. ``row_set`` names the sum the row
    belongs to on the ``kernels`` line (by default its path). Raises when
    the difference exceeds the tolerance."""
    import torch

    row = {
        "kernel": kernel, "path": path, "set": row_set or path, "shape": shape,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_diff": err, "tolerance": tol, "launches_per_run": per_run, **extra,
    }
    if timed if timed is not None else dtype == torch.bfloat16:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        row.update(
            kernel_ms=_time_ms(run, 20), plain_ms=_time_ms(run_ref, 3),
            library_ms=None if run_library is None else _time_ms(run_library, 20),
            **({} if run_unfused is None else {"unfused_ms": _time_ms(run_unfused, 20)}),
            bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
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
    """K1 and K5 against their plain versions at the eval forward's shapes,
    in float32 and bf16, times in bf16 (the forward's dtype); then K2
    (``check_topdown``)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        attn_fuse as k5,
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
            # K5 at each stage: the V-1 volumes of the stage's (D, G), the
            # 1/sqrt(C) of its features; one launch per forward
            cors = (torch.randn((V - 1, B, D, h, w, G), generator=gen, device=dev) * 0.5).to(dtype)
            args5 = (cors, cfg.attn_temp, C)
            got, want = k5.attn_fuse(*args5), k5.attn_fuse_ref(*args5)
            torch.cuda.synchronize()
            # the volumes read once and the fused volume written once; per
            # (view, pixel, d) G adds for the group sum, ~8 for the softmax
            # and the weights, 2G for the accumulation; G divides at the end
            nbytes = (cors.numel() + got.numel()) * cors.element_size()
            ops = (V - 1) * B * D * h * w * (3 * G + 8) + B * D * h * w * G
            _record(rows, "attn_fuse", "eval", [V - 1, B, D, h, w, G], dtype, _max_err(got, want),
                    k5.TOLERANCE[dtype] * _scale(want), 1,
                    lambda a=args5: k5.attn_fuse(*a), lambda a=args5: k5.attn_fuse_ref(*a),
                    nbytes, ops, FP32_FLOPS)
    rows += check_topdown(dev, gen)
    return rows


# K2's rows: (set, N, dtypes, modes per level); a level's mode is "with_u"
# (o and u: the eval forward's and the train forward's mid levels), "o" (the
# last level) or "u_only" (the train step's backward re-deriving u). Every
# row is held in float32 and bf16; the set's dtype is timed: the eval
# forward (B*V images), the train step (forward and backward, TRAIN_B*TRAIN_V
# images) in bf16, and one view of the float32 pipeline (PIPELINE_V images).
TOPDOWN_SETS = (
    ("eval", B * V, "bfloat16", ("with_u", "with_u", "o")),
    ("train", TRAIN_B * TRAIN_V, "bfloat16", ("with_u", "with_u", "o")),
    ("train", TRAIN_B * TRAIN_V, "bfloat16", ("u_only",) * 3),
    ("pipeline_float32", PIPELINE_V, "float32", ("with_u", "with_u", "o")),
)


def check_topdown(dev, gen):
    """K2 against ``topdown_level_ref`` at every level of each of
    ``TOPDOWN_SETS``, in float32 and bf16, with the set's dtype timed. The
    bound counts intra and skip read once, o and u (where written) written
    once and the weights; operations at the bf16 tensor-core rate in bf16,
    at the float32 CUDA-core rate in float32, where each route computes
    them."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )

    rows = []
    for row_set, N, timed_dtype, modes in TOPDOWN_SETS:
        for dtype in (torch.float32, torch.bfloat16):
            for lvl, ((cs, co), mode) in enumerate(zip(((32, 32), (16, 16), (8, 8)), modes)):
                hh, wh = H >> (3 - lvl), W >> (3 - lvl)
                intra = torch.randn((N, hh, wh, 64), generator=gen, device=dev).to(dtype)
                skip = torch.randn((N, 2 * hh, 2 * wh, cs), generator=gen, device=dev).to(dtype)
                wi = torch.randn((64, cs, 1, 1), generator=gen, device=dev) * cs ** -0.5
                bi = torch.randn((64,), generator=gen, device=dev) * 0.1
                wo = torch.randn((co, 64, 3, 3), generator=gen, device=dev) * 576 ** -0.5
                kw = {"with_u": mode == "with_u", "u_only": mode == "u_only"}
                args = (intra, skip, wi, bi, wo)
                got, want = k2.topdown_level(*args, **kw), k2.topdown_level_ref(*args, **kw)
                torch.cuda.synchronize()
                got, want = (got, want) if mode == "with_u" else ((got,), (want,))
                err = max(_max_err(a, b) for a, b in zip(got, want))
                tol = k2.TOLERANCE[dtype] * max(_scale(b) for b in want)
                esz = intra.element_size()
                npix = N * 4 * hh * wh
                written = (0 if mode == "u_only" else co) + (0 if mode == "o" else 64)
                nbytes = (intra.numel() + skip.numel() + npix * written) * esz \
                    + (wi.numel() + bi.numel() + (0 if mode == "u_only" else wo.numel())) * 4
                ops = npix * (64 * (2 * cs + 7) + (0 if mode == "u_only" else 2 * 9 * 64 * co))
                is_bf16 = dtype == torch.bfloat16
                _record(rows, "topdown", row_set.split("_")[0], [N, 2 * hh, 2 * wh, cs, co], dtype,
                        err, tol, 1, lambda a=args, k=kw: k2.topdown_level(*a, **k),
                        lambda a=args, k=kw: k2.topdown_level_ref(*a, **k), nbytes, ops,
                        BF16_TENSOR_FLOPS if is_bf16 else FP32_FLOPS, row_set=row_set,
                        timed=str(dtype) == f"torch.{timed_dtype}", mode=mode)
    return rows


def check_band_conv(dev):
    """K6 against ``band_conv_ref`` at ``BAND_CONV_LAYERS``, in float32 and
    bf16, with random weights, folded scale and bias; in bf16 the times of
    the kernel, the plain version, the library yardstick (``F.conv2d`` on the
    folded weight and bias, then in-place ``relu_``) and the unfused route K6
    replaces (cuDNN conv, ``TorchBatchNorm`` in eval, ``F.relu``). The bound
    counts x read and the output written once; operations at the bf16
    tensor-core rate."""
    import torch
    import torch.nn.functional as F

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
        TorchBatchNorm,
        conv2d_nhwc,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        band_conv as k6,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, h, w, ci, co, per_run in BAND_CONV_LAYERS:
            x = torch.randn((n, h, w, ci), generator=gen, device=dev).to(dtype)
            wt = torch.randn((co, ci, 3, 3), generator=gen, device=dev) * (9 * ci) ** -0.5
            bn = TorchBatchNorm(co).to(dev).eval()
            with torch.no_grad():
                bn.weight.copy_(torch.rand(co, generator=gen, device=dev) * 1.5 + 0.5)
                bn.bias.copy_(torch.randn(co, generator=gen, device=dev) * 0.2)
                bn.running_mean.copy_(torch.randn(co, generator=gen, device=dev) * 0.2)
                bn.running_var.copy_(torch.rand(co, generator=gen, device=dev) * 1.5 + 0.5)
                scale, bias = bn.folded()
            args = (x, wt, scale, bias)
            got, want = k6.band_conv(*args), k6.band_conv_ref(*args)
            torch.cuda.synchronize()
            x_nchw = x.permute(0, 3, 1, 2)
            w_lib = (wt * scale[:, None, None, None]).to(dtype)
            b_lib = bias.to(dtype)

            def run_library(x_nchw=x_nchw, w_lib=w_lib, b_lib=b_lib):
                return F.conv2d(x_nchw, w_lib, b_lib, 1, 1).relu_()

            def run_unfused(x=x, wt=wt, bn=bn):
                return F.relu(bn(conv2d_nhwc(x, wt, padding=1)))

            nbytes = (x.numel() + got.numel()) * x.element_size() + (wt.numel() + 2 * co) * 4
            with torch.no_grad():
                _record(rows, "band_conv", "eval", [n, h, w, ci, co], dtype,
                        _max_err(got, want), k6.TOLERANCE[dtype] * _scale(want), per_run,
                        lambda a=args: k6.band_conv(*a), lambda a=args: k6.band_conv_ref(*a),
                        nbytes, 2 * n * h * w * co * 9 * ci, BF16_TENSOR_FLOPS, run_library,
                        run_unfused)
            rows[-1]["layer"] = name
    return rows


def _train_hypotheses(batch, cfg):
    """The four stages' hypotheses as the train path makes them from a
    depth map: stage 1 the full inverse range (``init_inverse_range``),
    each later stage ``schedule_inverse_range`` around the scene's depth at
    the previous stage, +- ``depth_inter_r`` of that stage's spacing, as
    ``models/stagenet.py`` and ``models/mvs4net.py`` compute it."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.hypothesis import (
        init_inverse_range,
        schedule_inverse_range,
    )

    hypos = [init_inverse_range(batch["depth_values"], cfg.ndepths[0], H >> 3, W >> 3).float()]
    for s in range(1, 4):
        prev = hypos[-1]
        depth = batch["depth"][f"stage{s}"].float()
        itv = 1.0 / prev[:, 2] - 1.0 / prev[:, 1]
        r = cfg.depth_inter_r[s - 1]
        hypos.append(schedule_inverse_range(1.0 / depth + r * itv, 1.0 / depth - r * itv,
                                            cfg.ndepths[s], H >> (3 - s), W >> (3 - s)).float())
    return [h.contiguous() for h in hypos]


def check_warp_bwd(dev, batch):
    """K3 against ``warp_bwd_ref`` at the train step's four stages (B=6,
    the stage's C and D, 4 source views each), with g in float32 and bf16,
    on two sets of hypotheses: PR 4's (``full_range``: the full inverse
    range at every stage, jittered, the worst case for the footprint) and
    the train path's (``train``: ``_train_hypotheses``); in bf16 the times
    of the kernel, of the plain version and of the library yardstick
    ``aten.grid_sampler_2d_backward`` (bilinear, zeros, align_corners, the
    D planes stacked as rows). The yardstick runs in float32: grid_sampler
    takes its grid in the input's dtype, and a bf16 grid cannot hold a
    640-pixel coordinate."""
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
    train_hypos = _train_hypotheses(batch, cfg)
    for row_set in ("full_range", "train"):
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(4):
                h, w = H >> (3 - s), W >> (3 - s)
                C, D = cfg.fpn_out_channels[s], cfg.ndepths[s]
                projs = batch["proj_matrices"][f"stage{s + 1}"]
                rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
                if row_set == "train":
                    hypo = train_hypos[s]
                else:
                    hypo = _jittered_hypo(batch["depth_values"], D, h, w, gen)
                g = torch.randn((Bt, D, h, w, C), generator=gen, device=dev).to(dtype)
                shape = (Bt, h, w, C)
                got = k3.warp_bwd(g, rel, hypo, shape)
                want = k3.warp_bwd_ref(g, rel, hypo, shape)
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
                    library_diff[f"{row_set} stage{s + 1}"] = _max_err(lib, want)
                # the function's bytes: g, hypo and rel read once, dsrc written
                # once; the zeroing pass of the scatter design is not in the bound
                nbytes = g.numel() * g.element_size() + hypo.numel() * 4 + rel.numel() * 4 \
                    + got.numel() * 4
                a = (g, rel, hypo, shape)
                _record(rows, "warp_bwd", "train", [Bt, D, h, w, C], dtype, _max_err(got, want),
                        k3.TOLERANCE[dtype] * _scale(want), TRAIN_V - 1,
                        lambda a=a: k3.warp_bwd(*a), lambda a=a: k3.warp_bwd_ref(*a),
                        nbytes, Bt * D * h * w * (28 + 8 * C), FP32_FLOPS, run_library,
                        row_set=row_set)
    return rows, library_diff


def check_warp_fwd(dev, batch):
    """K4 against ``warp_fwd_ref`` at the train step's four stages (B=6,
    the stage's C and D, 4 source views each), in float32 and bf16; in bf16
    the times of the kernel, the plain version and the library yardstick
    ``F.grid_sample`` (bilinear, zeros, align_corners; the source permuted
    to NCHW and the grid normalised beforehand, the D planes stacked as
    rows). The yardstick runs in float32, as K3's does: grid_sample takes
    its grid in the input's dtype."""
    import torch
    import torch.nn.functional as F

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
        warp_coords,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_fwd as k4,
    )

    cfg = _dtu_model_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows, library_diff = [], {}
    Bt = TRAIN_B
    for dtype in (torch.float32, torch.bfloat16):
        for s in range(4):
            h, w = H >> (3 - s), W >> (3 - s)
            C, D = cfg.fpn_out_channels[s], cfg.ndepths[s]
            projs = batch["proj_matrices"][f"stage{s + 1}"]
            rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
            hypo = _jittered_hypo(batch["depth_values"], D, h, w, gen)
            src = torch.randn((Bt, h, w, C), generator=gen, device=dev).to(dtype)
            got, want = k4.warp_fwd(src, rel, hypo), k4.warp_fwd_ref(src, rel, hypo)
            torch.cuda.synchronize()
            run_library = None
            if dtype == torch.bfloat16:
                xy = warp_coords(rel, hypo).reshape(Bt, D * h, w, 2)
                grid = torch.stack([xy[..., 0] * (2.0 / (w - 1)) - 1.0,
                                    xy[..., 1] * (2.0 / (h - 1)) - 1.0], dim=-1)
                nchw = src.float().permute(0, 3, 1, 2).contiguous()

                def run_library(nchw=nchw, grid=grid):
                    return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                         align_corners=True)

                lib = run_library().reshape(Bt, C, D, h, w).permute(0, 2, 3, 4, 1)
                library_diff[f"stage{s + 1}"] = _max_err(lib, want)
            # the source, hypotheses and projection read once, the warped
            # volume written once; per output element 4 products and 3 sums,
            # per pixel the coordinates (~28 operations, as K1's)
            nbytes = src.numel() * src.element_size() + hypo.numel() * 4 + rel.numel() * 4 \
                + got.numel() * got.element_size()
            _record(rows, "warp_fwd", "train", [Bt, D, h, w, C], dtype, _max_err(got, want),
                    k4.TOLERANCE[dtype] * _scale(want), TRAIN_V - 1,
                    lambda a=(src, rel, hypo): k4.warp_fwd(*a),
                    lambda a=(src, rel, hypo): k4.warp_fwd_ref(*a),
                    nbytes, Bt * D * h * w * (28 + 7 * C), FP32_FLOPS, run_library)
    return rows, library_diff


def check_small_forward_against_cpu(dev):
    """The card's float32 forward against the CPU's plain forward, same
    weights, on a 64x128 scene: attention within 1e-3 and depth equal at
    >= 99% of pixels per stage (argmax near-ties may flip)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks

    cfg = _dtu_model_config("float32")
    cpu_model = checks.seeded_model(cfg, SEED + 1, "cpu")
    gpu_model = checks.seeded_model(cfg, SEED + 1, dev)
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


def drive_train(dev, batch, counters, kernels):
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
    if counts != TRAIN_LAUNCHES:
        raise AssertionError(f"launches per train step {counts}, want {TRAIN_LAUNCHES}")
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
        **{name: (f"{name}_kernel",) for name in kernels}, "conv_library": CONV_LIBRARY})
    train = {
        "B": TRAIN_B, "V": TRAIN_V, "H": H, "W": W, "dtype": "bfloat16",
        "ms_per_step": ms, "ms_per_step_rounds": round_ms, "samples_per_s": TRAIN_B * 1e3 / ms,
        "loss_per_step": losses, "launches_per_step": counts, "timed_steps": reps * rounds,
        "peak_memory_gb": peak_gb,
    }
    return train, prof, counts


def drive_pipeline(dev, counters, kernels):
    """The eval CLI's path at full width (``checks.run_pipeline``): the
    scripts/eval_dtu.sh model in float32 (weights and BatchNorm statistics
    from ``PIPELINE_SEED``), B=1, a SyntheticEvalDataset of 4 views at
    512x640 with 192 hypotheses; depth maps of every reference view, each
    filtered against its 3 sources (photomask 0.3, geomask 2, condmask 1.0 /
    0.01), the fused PLY written to ``PIPELINE_PLY``. One warm-up run, then the counted run.
    Then the same pipeline at 64x128 on the card against the CPU."""
    import numpy as np
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        SyntheticEvalDataset,
    )

    model = checks.seeded_model(checks.eval_dtu_config(), PIPELINE_SEED, dev)
    ds = SyntheticEvalDataset(V=PIPELINE_V, H=H, W=W)
    checks.run_pipeline(model, ds, dev)              # warm-up
    os.makedirs(os.path.dirname(PIPELINE_PLY), exist_ok=True)
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    run = checks.run_pipeline(model, ds, dev, ply_path=PIPELINE_PLY)   # counted
    counts = {name: mod.launches for name, mod in counters.items()}
    per_view = {name: n / len(ds) for name, n in counts.items()}
    if per_view != PIPELINE_LAUNCHES_PER_VIEW:
        raise AssertionError(f"pipeline launches per view {per_view}, "
                             f"want {PIPELINE_LAUNCHES_PER_VIEW}")
    n_points = len(run["points"])
    if n_points == 0 or not np.isfinite(run["points"]).all():
        raise AssertionError(f"fused cloud of {n_points} points, or not finite")
    if os.path.getsize(PIPELINE_PLY) < 15 * n_points:
        raise AssertionError(f"{PIPELINE_PLY}: {os.path.getsize(PIPELINE_PLY)} bytes")
    for v, d in run["depths"].items():
        if d.shape != (H, W) or not np.isfinite(d).all():
            raise AssertionError(f"view {v}: depth {d.shape} not finite/shaped")
    prof = profile_run(lambda: checks.run_pipeline(model, ds, dev), {
        **{name: (f"{name}_kernel",) for name in kernels}, "conv_library": CONV_LIBRARY})
    print(json.dumps({"pipeline_profile": prof}))
    return {
        "B": 1, "V": PIPELINE_V, "H": H, "W": W, "dtype": "float32", "hypotheses": 192,
        "ms_per_view_forward": float(np.median(run["forward_s"])) * 1e3,
        "ms_per_view_forward_all": [x * 1e3 for x in run["forward_s"]],
        "ms_per_view_filter": float(np.median(run["filter_s"])) * 1e3,
        "ms_per_view_filter_all": [x * 1e3 for x in run["filter_s"]],
        "launches_per_view": per_view, "fused_points": n_points,
        "points_per_view": run["point_counts"],
        "final_mask_share": float(np.mean([m.mean() for m in run["final_masks"].values()])),
        "ply": PIPELINE_PLY, "ply_bytes": os.path.getsize(PIPELINE_PLY),
        "small_vs_cpu_float32": checks.check_pipeline(dev),
    }, counts


def _read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def drive_train_cli(counters):
    """The train CLI in this process at full width (``TRAIN_CLI_FLAGS``): one
    epoch (2 steps, 2 validation batches); ``--resume --epochs 2``, which
    must continue at epoch 2 and step 2; ``--mode test``; ``--mode
    profile``. The counters are set to 0 before each part and read after
    it. Raises on a non-finite loss, a missing checkpoint or record, a
    learning rate off the schedule or a wrong count."""
    import shutil

    import numpy as np

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import train as cli
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.schedule import (
        make_schedule,
    )

    shutil.rmtree(TRAIN_CLI_LOGDIR, ignore_errors=True)
    metrics = os.path.join(TRAIN_CLI_LOGDIR, "metrics.jsonl")

    def part(extra, steps, val_batches):
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = cli.main(TRAIN_CLI_FLAGS + extra)
        seconds = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in counters.items()}
        want = {name: steps * TRAIN_LAUNCHES[name] + val_batches * VAL_LAUNCHES[name]
                for name in counters}
        if counts != want:
            raise AssertionError(f"train CLI {extra}: launches {counts}, want {want}")
        return out, counts, seconds

    state, counts_fit, s_fit = part(["--epochs", "1"], 2, 2)
    ckpt = os.path.join(TRAIN_CLI_LOGDIR, "model_00.ckpt")
    first = _read_records(metrics)
    if not os.path.exists(ckpt) or [(r["mode"], r["step"]) for r in first] != [
            ("train", 0), ("train", 1), ("test", 0), ("test", 1), ("fulltest", 2)]:
        raise AssertionError(f"epoch 1: {ckpt} or records missing: "
                             f"{[(r['mode'], r['step']) for r in first]}")
    t0 = time.perf_counter()
    timed = save_checkpoint(TRAIN_CLI_LOGDIR, 99, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    os.remove(timed)
    state, counts_resume, s_resume = part(["--epochs", "2", "--resume"], 2, 2)
    resumed = _read_records(metrics)[len(first):]
    if state.step != 4 or [(r["mode"], r["step"]) for r in resumed] != [
            ("train", 2), ("train", 3), ("test", 2), ("test", 3), ("fulltest", 4)]:
        raise AssertionError(f"resume: step {state.step}, records "
                             f"{[(r['mode'], r['step']) for r in resumed]}")
    records = first + resumed
    sched = make_schedule("MS", 1e-3, milestones_iters=[12, 16, 18], gamma=0.5)
    train_recs = [r for r in records if r["mode"] == "train"]
    for r in records:
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"train CLI: loss not finite in {r['mode']} {r['step']}")
        if r["mode"] == "train" and r["lr"] != sched(r["step"]):
            raise AssertionError(f"step {r['step']}: lr {r['lr']}, schedule {sched(r['step'])}")
    avg, counts_test, s_test = part(["--mode", "test"], 0, 2)
    if not np.isfinite(avg["loss"]):
        raise AssertionError(f"--mode test: loss {avg['loss']}")
    prof, counts_profile, s_profile = part(["--mode", "profile"], PROFILE_STEPS, 0)
    if not os.path.getsize(prof["trace"]):
        raise AssertionError(f"--mode profile: empty trace {prof['trace']}")
    ckpt_bytes = os.path.getsize(ckpt)
    # the two checkpoints (12 MB each) stay out of what chiprun_out/ brings back
    for name in os.listdir(TRAIN_CLI_LOGDIR):
        if name.endswith(".ckpt"):
            os.remove(os.path.join(TRAIN_CLI_LOGDIR, name))
    step_ms = [r["step_s"] * 1e3 for r in train_recs]
    val_ms = [r["step_s"] * 1e3 for r in records if r["mode"] == "test"]
    return {
        "B": TRAIN_B, "V": TRAIN_V, "H": H, "W": W, "dtype": "bfloat16",
        "steps": len(train_recs), "profile_steps": PROFILE_STEPS,
        "host_ms_per_step": float(np.median(step_ms[1:])), "host_ms_per_step_all": step_ms,
        "val_ms_per_batch": float(np.median(val_ms)), "val_ms_per_batch_all": val_ms,
        "profile_steady_ms_per_step": prof["stats"]["steady_state_s"] * 1e3,
        "profile_first_call_s": prof["stats"]["first_call_s"],
        "launches_per_train_step": {k: v / PROFILE_STEPS for k, v in counts_profile.items()},
        "launches_per_val_batch": {k: v / 2 for k, v in counts_test.items()},
        "launches": {"fit": counts_fit, "resume": counts_resume, "test": counts_test,
                     "profile": counts_profile},
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_ms": save_ms,
        "resume_epoch": resumed[0]["step"] // 2 + 1, "resume_step": resumed[0]["step"],
        "lr_per_step": [r["lr"] for r in train_recs],
        "loss_per_step": [r["loss"] for r in train_recs],
        "fulltest_loss": [r["loss"] for r in records if r["mode"] == "fulltest"],
        "test_mode_loss": avg["loss"], "trace": prof["trace"],
        "trace_bytes": os.path.getsize(prof["trace"]),
        "part_seconds": {"fit": s_fit, "resume": s_resume, "test": s_test,
                         "profile": s_profile},
    }


def _per_run(rows):
    """Sums over the timed rows of each set, per run of the set's path
    (times the rows' launches per run): the kernel's time, the plain
    version's, the bound and its parts, the library yardstick's (None if a
    row has none)."""
    sums = {}
    for row_set in {r["set"] for r in rows}:
        timed = [r for r in rows if r["set"] == row_set and "kernel_ms" in r]
        if not timed:
            continue

        def total(key, timed=timed):
            return sum(r[key] * r["launches_per_run"] for r in timed)

        entry = {"ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
                 "bound_ms": total("bound_ms"), "bytes": total("bytes"), "ops": total("ops"),
                 "bound_by": "operations" if total("ops_ms") > total("bytes_ms") else "bytes",
                 "library_ms": None if any(r["library_ms"] is None for r in timed)
                 else total("library_ms")}
        sums[row_set] = entry
    return sums


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to measure", file=sys.stderr)
        return 1
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import setup_device
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        attn_fuse as k5,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        band_conv as k6,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_bwd as k3,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_cor as k1,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_fwd as k4,
    )

    counters = {"warp_cor": k1, "topdown": k2, "warp_bwd": k3, "warp_fwd": k4, "attn_fuse": k5,
                "band_conv": k6}
    kernels = _build.KERNELS
    # the eval CLI's device setup (TF32 off), so that every phase runs at
    # the precision a user of the port gets
    dev = setup_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}))

    t0 = time.perf_counter()
    built = _build.build(kernels)
    build_s = time.perf_counter() - t0
    for name in kernels:
        log = _build.library_path(name).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(json.dumps({"build": {"wall_s": build_s,
                                **{k: v[0] for k, v in built.items()}}}))

    batch = _scene(B, V, H, W, dev)
    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    rows = check_kernels(dev, batch) + check_band_conv(dev)
    k3_rows, bwd_library_diff = check_warp_bwd(dev, train_batch)
    k4_rows, fwd_library_diff = check_warp_fwd(dev, train_batch)
    rows += k3_rows + k4_rows
    print(json.dumps({"kernel_shapes": rows,
                      "warp_bwd_library_max_abs_diff": bwd_library_diff,
                      "warp_fwd_library_max_abs_diff": fwd_library_diff}))

    model = checks.seeded_model(_dtu_model_config(), SEED, dev)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    with torch.inference_mode():
        model(*args)                      # warm-up
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        out = model(*args)                # the main path, counted
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
        if counts != EVAL_LAUNCHES:
            raise AssertionError(f"launches per forward {counts}, want {EVAL_LAUNCHES}")
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
        for mod in counters.values():
            mod.launches = 0
        round_ms = [_time_ms(lambda: model(*args), reps) for _ in range(rounds)]
        fwd_ms = sorted(round_ms)[rounds // 2]
        calls = rounds * (reps + 1)
        timed_counts = {name: mod.launches for name, mod in counters.items()}
        if timed_counts != {name: n * calls for name, n in EVAL_LAUNCHES.items()}:
            raise AssertionError(f"timed forwards launched {timed_counts}")
        torch.cuda.reset_peak_memory_stats()
        profile = profile_run(lambda: model(*args), {
            **{name: (f"{name}_kernel",) for name in kernels}, "conv_library": CONV_LIBRARY})
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
    train, train_profile, train_counts = drive_train(dev, train_batch, counters, kernels)
    print(json.dumps({"train": train}))
    print(json.dumps({"train_profile": train_profile}))
    del train_batch
    torch.cuda.empty_cache()
    pipeline, pipeline_counts = drive_pipeline(dev, counters, kernels)
    print(json.dumps({"pipeline": pipeline}))
    torch.cuda.empty_cache()
    train_cli = drive_train_cli(counters)
    print(json.dumps({"train_cli": train_cli}))

    kernel_line = []
    for name, src, replaces, also_serves, row_set in (
        ("warp_cor", "csrc/warp_cor.cu", "warp_fwd_v3.py:438",
         ["warp_fwd_v3.py:522 (with ref, via warp_mxu.warp_cor_v3)"], "eval"),
        ("topdown", "csrc/topdown.cu", "topdown_fused.py:317",
         ["topdown_fused.py:727 (topdown_fused_level mode v2)"], "eval"),
        ("warp_bwd", "csrc/warp_bwd.cu", "warp_xband_bwd.py:410",
         ["warp_xband_bwd.py:467 (modes v1-v4)"], "train"),
        ("warp_fwd", "csrc/warp_fwd.cu", "warp_fwd_v3.py:522 (no ref, via warp_mxu._warp_v3)",
         ["warp_xband_kernel.py:111", "warp_kernel.py:83"], "train"),
        ("attn_fuse", "csrc/attn_fuse.cu", "attn_fuse.py:98", [], "eval"),
        ("band_conv", "csrc/band_conv.cu", "reg_band_proto.py:89", [], "eval"),
    ):
        mine = [r for r in rows if r["kernel"] == name]
        sums = _per_run(mine)
        main = sums[row_set]
        entry = {
            "name": name, "route": "cuda", "source": f"{PKG}/{src}",
            "replaces": f"{JAX_PKG_OPS}/{replaces}",
            "also_serves": [f"{JAX_PKG_OPS}/{a}" for a in also_serves],
            "launches": counts[name] + train_counts[name] + pipeline_counts[name],
            "launches_eval": counts[name], "launches_train": train_counts[name],
            "launches_pipeline": pipeline_counts[name],
            "launches_train_cli": sum(c[name] for c in train_cli["launches"].values()),
            "timed_per": "eval forward" if row_set == "eval" else "train step",
            "max_abs_err": max(r["max_abs_diff"] for r in mine if r["dtype"] == "bfloat16"),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        if name == "band_conv":
            # the route it replaces, and the least time of its sums on the
            # float32 CUDA cores, where this kernel computes them
            entry["unfused_ms"] = sum(r["unfused_ms"] * r["launches_per_run"]
                                      for r in mine if "unfused_ms" in r)
            entry["cuda_core_bound_ms"] = main["ops"] / FP32_FLOPS * 1e3
        if name == "topdown":
            # the train step (forward and the backward's u_only, bf16) and
            # one view of the float32 pipeline
            entry["train_step"] = sums["train"]
            entry["pipeline_float32_view"] = sums["pipeline_float32"]
        if name == "warp_bwd":
            # PR 4's hypotheses: the full inverse range at every stage
            entry["full_range"] = sums["full_range"]
        kernel_line.append(entry)
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
