#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the port's six CUDA kernels from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints the build seconds and ptxas's
   register and shared-memory report.
2. Holds each kernel against its plain PyTorch version at every shape the
   flagship paths give it, in float32 (TF32 off) and in bf16, and times
   both with CUDA events (back to back from the host, which adds the
   host's time per launch where that is longer; beside it the kernel's and
   its library yardstick's device time: 20 launches captured in one CUDA
   graph and replayed): K1 (warp + group correlation, on
   the eval forward's own hypotheses and on the full inverse range at every
   stage, and in float32 at one view of the B1 pipeline), K5 (attention
   accumulation, also in float32 at one B1 pipeline view) and K6 (3x3 conv
   + folded BatchNorm + ReLU, beside ``F.conv2d`` + ``relu_`` on the folded
   weights and the unfused conv + BatchNorm + ReLU it replaces, at every 3x3
   stride-1 layer of the stem and Reg2D.conv0, timed in both dtypes, the
   rows that back its route rule in ``models/layers.py``, and in float32 at
   one B1 pipeline view) at the eval forward's shapes; K2 (FPN top-down level) at the eval
   forward's, the train step's (its 3 forward launches and the backward's 3
   ``u_only`` launches, N = 30) and, in float32, one pipeline view's; K3
   (warp backward) at the train step's on two sets of hypotheses (the full
   inverse range at every stage, as PR 4 timed it, and the train path's
   windows around a depth map), and K4 (warp forward) at the train step's
   on the same two sets, beside their library
   yardsticks ``aten.grid_sampler_2d_backward`` and ``F.grid_sample``.
   K1's, K4's, K5's and K6's rows name the launch shape they took
   (``plan``).
   Then every kernel at the widths of FPN base 4 and 16 (``OTHER_WIDTHS``,
   the same checks at those widths): K1, K5 and K2 at the eval forward's
   shapes, K3 and K4 at the train step's, each row naming the instance it took (the
   generic instances: K1 at C 4 and 128 and G 16, K4 at C 4 and 128, K2 at
   Ci 32 and 128; K5 at G 16 on its register kernel), and K5's workspace
   kernel (D over 32 or G over 16: ``K5_WORKSPACE``, set ``workspace``).
3. Drives the flagship eval forward (the JAX package's ``_dtu_model()``
   config: FPN, reg2d, group correlation (8,8,4,4), inverse depth,
   attn_temp 2, bf16, mono) at B=4, V=4, 512x640 with seeded random weights
   and BatchNorm statistics on plane-scene inputs: the launch counters are
   set to 0 just before one forward and read just after (K1 12 launches,
   K2 3, K5 4, K6 12: every 3x3 stride-1 layer on its bf16 route), then
   three rounds of five forwards are timed.
4. Checks the eval output: finite depth of the expected shape, and, on a
   small input, the card's forward against the CPU's plain forward with the
   same weights in float32 (``checks.check_forward``), at FPN base 8 and
   then at base 4 and 16 (``forward_other_widths``).
5. The top-down chain's ``autograd.Function`` (K2 forward, K2 re-deriving
   ``u`` in the backward) against autograd through the plain chain, at the
   train shape (30 images), in float32 and bf16 (``checks.py``).
6. A small float32 train step on the card against the same step on the
   CPU (B=2, V=3, 64x128; ``checks.check_train_step``): the card takes the
   CPU's next-stage hypotheses and its gradients at the cost volumes and
   mono depths, then the loss, the FPN outputs' gradients, every
   parameter's gradient, and a nonzero gradient for every parameter on the
   card are held to fixed limits; then the same at FPN base 4
   (``small_train_step_other_width``).
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
   before the run and read just after (per view K1 12, K2 3, K5 4, K6 10:
   its float32 route stops at 32 channels),
   and a profile of one more run. Then the same pipeline at 64x128 on the
   card against the CPU (``checks.check_pipeline``). K6's launches per
   forward follow its route rule (``_k6_launches``).
9. Drives the train CLI (``cli.train.main`` in this process) at full width
   with scripts/train_dtu.sh's model, loss and optimizer flags on 12
   synthetic 512x640 scenes of 5 views, B=6, logdir ``chiprun_out/
   train_cli``: one epoch (2 steps, 2 validation batches, ``model_00.ckpt``),
   ``--resume --epochs 2`` (continues at epoch 2, step 2), ``--mode test``
   and ``--mode profile`` (a Chrome trace); the counters are set to 0 before
   each part and read after it. The CLI's steps are captured graphs: each
   part's first train step and first validation batch launch every kernel
   twice (the warm-up's and the capture's launches), the later ones replay
   (per captured train step K4 16, K3 16, K2 6, K6 0; per validation batch
   K1 16, K2 3, K5 4, K6 12).
10. Drives every model variant (``checks.VARIANTS``: the flagship with one
   change, pos-enc sine and learned, reg3d, the CAM/DCAM/PAM/PDAM mid
   blocks, GroupNorm, ASFF, the two ConvNeXt pyramids, DCN heads with
   BatchNorm and with GroupNorm; ``drive_variants``): per variant, the
   counters set to 0 just before one B4 V4 512x640 bf16 eval forward and
   read just after, held to its launches (K1 12, K2 3, K5 4, K6 from the
   route rule over its layers, ``_k6_launches``), three rounds of five
   timed forwards and one profiled; the same around one DTU train step
   (K4 16, K3 16, K2 6, K6 0) and three timed steps; then the small
   float32 forward and train step against the CPU. K6's rows also hold
   ASFF's ``expand`` convs (sets ``asff_eval``, ``asff_eval_float32``).
11. The row-sharded ``--space`` eval (``drive_space``), on this one card
   (``parallel.mesh.sharded_eval_forward`` over ``[cuda:0] * S``: the
   decomposition, not multi-card speed): the B4 V4 512x640 flagship in
   float32 and bf16 at S 2 and 4, and a Tanks&Temples-sized B1 V5
   1024x1920 bf16 view at S 4, halo 48; the counters set to 0 just before
   one sharded forward and read just after (S times the unsharded
   forward's), every stage held to the unsharded forward
   (``checks.compare_space``), timed and profiled; K1, K5 and K6 at every
   window shape against their plain versions (sets
   ``space_<run>_S<S>_<dtype>``).
12. Data-parallel training (``drive_ddp``): an NCCL group of one rank, the
   DTU recipe through ``parallel.mesh.data_parallel`` for each ``dp_impl``
   against the bare step from the same seed (``checks.check_ddp_step``),
   the counters around all of it; then ``torchrun --standalone
   --nproc_per_node 1`` running the train CLI for one epoch.
13. The debug dumps (``drive_debug``): the eval CLI with ``--debug_model
   255`` on a 4-view 512x640 scene, on the card (counted: the captured
   forward's warm-up and capture, the dump's eager forward, and K4 for bits
   5 and 6) and with ``--device cpu``, the dumps compared
   (``checks.compare_debug_dumps``).
14. The port's drivers (``drive_drivers``), each as a user runs it: the
   eval bench (``python -m <port>.bench`` at its pinned B4 V4 512x640,
   CHAIN 5, ROUNDS 10, GROUPS 3, its chain a captured graph; its last
   line printed back), the first call of ``graft_entry.entry()``'s ``fn``
   at the bench shape, which captures (counted: twice K1 12, K2 3, K5 4,
   K6 12), and a replay that counts none, ``scripts/bench_scaling.py``
   at one rank (its set-up split and row), the dry run
   ``graft_entry 1`` and ``tools/train_demo.py`` for its 300 steps.
15. The captured entry points (``drive_graphs``; ``utils/graphs.py``, the
   counterpart of the JAX package's ``jax.jit``) beside their eager forms
   in this call: the eval forward at B4 V4 512x640 bf16 eager and
   captured (ms, device time and busy share, peak memory allocated and
   reserved, the first call counted), the replay bit-equal to the eager
   forward; the eval step's scalars bit-equal; the DTU train step captured
   (ms, busy share, peak) and 3 replayed steps within 4x the eager steps'
   run-to-run noise; the float32 pipeline with a captured forward and
   filter, its fused point count equal to the eager run's; the bench's
   captured chain from phase 14.

Phases 7, 8 and 10 read the eager forms (``utils/graphs.eager``): the
readings that phase 15 holds the captured forms against. Launch counters
count the launches the wrappers make: a captured function's first call
with a new input signature launches every kernel twice (its eager warm-up
and its capture), and a replay launches none; the ``kernels`` line's
``launches_graphs`` are phase 15's counted first calls.

Lines before the last: the card's name and power limit (``nvidia-smi``),
the build, a ``kernel_shapes`` line, a ``profile`` line (device time of
one forward by kernel), a ``forward`` line, a ``forward_other_widths``
line, a ``chain_backward`` line, a ``small_train_step`` line, a
``small_train_step_other_width`` line, a ``train`` line, a ``train_profile`` line, a
``pipeline_profile`` line, a ``pipeline`` line, a ``train_cli`` line, a
``variant`` line per variant, a ``variants`` line, a ``space_kernel_shapes``
line, a ``space`` line, a ``ddp`` line, a ``debug`` line, a ``drivers`` line,
a ``graphs`` line and a ``kernels`` line. The last line is ``{"ok": true, "device": {...}}``; any
failed check raises before it, with a non-zero exit. Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.graft_entry import dtu_model_config

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
# (K6's launches follow its route rule, models/layers.band_conv_route:
# main() fills them in from _k6_launches)
EVAL_LAUNCHES = {"warp_cor": 12, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0, "attn_fuse": 4,
                 "band_conv": None}
TRAIN_LAUNCHES = {"warp_cor": 0, "topdown": 6, "warp_bwd": 16, "warp_fwd": 16, "attn_fuse": 0,
                  "band_conv": 0}
PIPELINE_LAUNCHES_PER_VIEW = {"warp_cor": 12, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0,
                              "attn_fuse": 4, "band_conv": None}
VAL_LAUNCHES = {"warp_cor": 16, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0, "attn_fuse": 4,
                "band_conv": None}
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
# K6 at the eval forward's 3x3 stride-1 conv + BatchNorm + ReLU layers at
# batch b (V4 512x640: N = b*V in the FPN stem, b*D in Reg2D.conv0 with D =
# 8, 8, 4, 4): (name, N, H, W, Ci, Co, layers of that shape per forward). A
# row's launches per forward are its layers where
# models/layers.band_conv_route puts the shape on K6's route in the row's
# dtype, else 0; every row is timed beside the unfused route, so that the
# rule rests on the rows of the same call.
def _band_conv_layers(b):
    return (
        ("stem conv0.0", b * V, H, W, 3, 8, 1),
        ("stem conv0.1", b * V, H, W, 8, 8, 1),
        ("stem conv1.1, conv1.2", b * V, H // 2, W // 2, 16, 16, 2),
        ("stem conv2.1, conv2.2", b * V, H // 4, W // 4, 32, 32, 2),
        ("stem conv3.1, conv3.2", b * V, H // 8, W // 8, 64, 64, 2),
        ("Reg2D.conv0 stage1", b * 8, H // 8, W // 8, 8, 8, 1),
        ("Reg2D.conv0 stage2", b * 8, H // 4, W // 4, 8, 8, 1),
        ("Reg2D.conv0 stage3", b * 4, H // 2, W // 2, 4, 8, 1),
        ("Reg2D.conv0 stage4", b * 4, H, W, 4, 8, 1),
    )


def _asff_band_conv_layers(b):
    """ASFF's ``expand`` conv + BatchNorm + ReLU per stage, at the stage's
    resolution and width (64, 32, 16, 8 at FPN base 8), the views folded
    into the batch: one layer per forward each."""
    return tuple((f"ASFF.expand stage{s + 1}", b * V, H >> (3 - s), W >> (3 - s),
                  64 >> s, 64 >> s, 1) for s in range(4))


# K6's row sets: (set, batch, dtype); the B4 eval forward in both dtypes and
# one view of the float32 pipeline (B1); ASFF's rows at B4 make the sets
# asff_eval and asff_eval_float32
BAND_CONV_SETS = (("eval_float32", B, "float32"), ("eval", B, "bfloat16"),
                  ("pipeline_float32", 1, "float32"))


def _variant_k6_layers(b, variant):
    """The 3x3 stride-1 conv + BatchNorm + ReLU layers of an eval forward
    of the flagship model with the ``variant``'s fields (``checks.
    VARIANTS``), rows as ``_band_conv_layers``: the stem's where it is
    BatchNorm (all of FPN4's, the ConvNeXt pyramids' two ``conv0``),
    Reg2D.conv0 with reg2d, ASFF's ``expand`` with asff."""
    convnext = variant.get("arch_mode", "fpn") != "fpn"
    rows = []
    for row in _band_conv_layers(b):
        if row[0].startswith("stem"):
            if variant.get("gn") or (convnext and not row[0].startswith("stem conv0")):
                continue
        elif variant.get("reg_mode", "reg2d") != "reg2d":
            continue
        rows.append(row)
    if variant.get("asff"):
        rows += _asff_band_conv_layers(b)
    return rows


def _k6_launches(dtype, variant=None) -> int:
    """K6's launches per eval forward of the flagship model (FPN base 8),
    or of its ``variant``, in ``dtype``: the layers of
    ``_variant_k6_layers(B, variant)`` on its route
    (``models/layers.band_conv_route``)."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
        band_conv_route,
    )

    return sum(n for _, _, _, _, ci, co, n in _variant_k6_layers(B, variant or {})
               if band_conv_route(ci, co, dtype))


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


def _time_graph_ms(fn, reps, rounds=3):
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph (after a warm-up call), the graph replayed ``rounds`` times
    between CUDA events, the median round over ``reps``. Unlike
    ``_time_ms`` it leaves out the host's time per call (the wrappers'
    checks, ctypes and Python, ~20-40 us), which hid the device time of
    every launch shorter than that."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[rounds // 2]


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
    unfused route the kernel replaces, each timed back to back from the host
    (``_time_ms``: ``kernel_ms``, ``plain_ms``, ``library_ms``,
    ``unfused_ms``); beside them the kernel's and the library call's device
    time (``_time_graph_ms``: ``kernel_device_ms``, ``library_device_ms``).
    ``row_set`` names
    the sum the row belongs to on the ``kernels`` line (by default its
    path). Raises when the difference exceeds the tolerance."""
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
            kernel_device_ms=_time_graph_ms(run, 20),
            library_device_ms=None if run_library is None else _time_graph_ms(run_library, 20),
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


# FPN widths beside the flagship's base 8, which the kernels take through
# their generic instances: (--fpn_base_channel, --group_cor_dim); their rows
# make the sets eval_base{b} and train_base{b}
OTHER_WIDTHS = ((4, (8, 8, 4, 2)), (16, (16, 8, 4, 4)))


def _stage_channels(base, s):
    """The channels stage ``s`` (0 = 1/8 resolution) carries at FPN base
    ``base``: 8b, 4b, 2b, b."""
    return (8 * base) >> s


def _k1_rows(rows, dev, batch, gen, base, groups, dtype, hyps, row_set, timed):
    """K1 against ``warp_cor_ref`` at the four stages of the eval forward
    (B and the stage's D, C and G at FPN base ``base``, 3 source views, one
    launch each), on the path's own hypotheses (``hyps == "path"``:
    ``_path_hypotheses`` from the batch's depth) or the full inverse range
    at every stage, jittered (``"full_range"``). A row's ``instance`` is
    the launch shape the kernel takes (``warp_cor.plan``)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_cor as k1,
    )

    cfg = dtu_model_config()
    nb = batch["depth_values"].shape[0]
    path_hypos = _path_hypotheses(batch, cfg) if hyps == "path" else None
    for s in range(4):
        h, w = H >> (3 - s), W >> (3 - s)
        C, G, D = _stage_channels(base, s), groups[s], cfg.ndepths[s]
        projs = batch["proj_matrices"][f"stage{s + 1}"]
        rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
        hypo = path_hypos[s] if hyps == "path" else _jittered_hypo(
            batch["depth_values"], D, h, w, gen)
        src = torch.randn((nb, h, w, C), generator=gen, device=dev).to(dtype)
        ref = torch.randn((nb, h, w, C), generator=gen, device=dev).to(dtype)
        args = (src, ref, rel, hypo, G)
        got, want = k1.warp_cor(*args), k1.warp_cor_ref(*args)
        torch.cuda.synchronize()
        out_bytes = got.numel() * got.element_size()
        nbytes = sum(t.numel() * t.element_size() for t in args[:4]) + out_bytes
        _record(rows, "warp_cor", "eval", [nb, D, h, w, C, G], dtype, _max_err(got, want),
                k1.TOLERANCE[dtype] * _scale(want), V - 1,
                lambda a=args: k1.warp_cor(*a), lambda a=args: k1.warp_cor_ref(*a),
                nbytes, nb * D * h * w * (28 + 9 * C + G), FP32_FLOPS, row_set=row_set,
                timed=timed, hypotheses=hyps, instance=k1.plan(nb, D, h, w, C, G))


def check_kernels(dev, batch, base=8, groups=(8, 8, 4, 4), row_set="eval",
                  k1_sets=(("path", "eval"), ("full_range", "eval_full_range"))):
    """K1 and K5 against their plain versions at the eval forward's shapes
    at FPN base ``base`` and ``groups`` (the stages' C and G), in float32
    and bf16, times in bf16 (the forward's dtype). K1 on each ``(hypotheses,
    row set)`` of ``k1_sets`` (``_k1_rows``); K5 in ``row_set``
    (``_k5_rows``)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + base)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for hyps, k1_set in k1_sets:
            _k1_rows(rows, dev, batch, gen, base, groups, dtype, hyps, k1_set,
                     dtype == torch.bfloat16)
        _k5_rows(rows, dev, gen, B, base, groups, dtype, row_set, dtype == torch.bfloat16)
    return rows


def _attn_fuse_args(dev, gen, batch, s, base, groups, dtype):
    """K5's inputs at stage ``s`` of the eval forward (B ``batch``, FPN base
    ``base``): the V-1 volumes of the stage's (D, G), scaled as a group
    correlation, attn_temp and the stage's C."""
    import torch

    cfg = dtu_model_config()
    h, w = H >> (3 - s), W >> (3 - s)
    D, G = cfg.ndepths[s], groups[s]
    cors = (torch.randn((V - 1, batch, D, h, w, G), generator=gen, device=dev) * 0.5).to(dtype)
    return cors, cfg.attn_temp, _stage_channels(base, s)


def _k5_rows(rows, dev, gen, batch, base, groups, dtype, row_set, timed):
    """K5 against ``attn_fuse_ref`` at the four stages (one launch each per
    forward); a row's ``instance`` is its launch shape (``attn_fuse.plan``)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        attn_fuse as k5,
    )

    for s in range(4):
        args5 = _attn_fuse_args(dev, gen, batch, s, base, groups, dtype)
        cors = args5[0]
        S, nb, D, h, w, G = cors.shape
        got, want = k5.attn_fuse(*args5), k5.attn_fuse_ref(*args5)
        torch.cuda.synchronize()
        # the volumes read once and the fused volume written once; per
        # (view, pixel, d) G adds for the group sum, ~8 for the softmax
        # and the weights, 2G for the accumulation; G divides at the end
        nbytes = (cors.numel() + got.numel()) * cors.element_size()
        ops = S * nb * D * h * w * (3 * G + 8) + nb * D * h * w * G
        _record(rows, "attn_fuse", "eval", list(cors.shape), dtype, _max_err(got, want),
                k5.TOLERANCE[dtype] * _scale(want), 1,
                lambda a=args5: k5.attn_fuse(*a), lambda a=args5: k5.attn_fuse_ref(*a),
                nbytes, ops, FP32_FLOPS, row_set=row_set, timed=timed,
                instance=k5.plan(nb, D, h, w, G, dtype))


# K5's workspace kernel (D over 32 or G over 16), off every path the repo's
# configurations run: (D, G) at the base-16 stage-1 volumes (B4, 64x80,
# three source views), one past the register kernel's depths and one past
# its groups; set "workspace", one launch per row
K5_WORKSPACE = ((40, 16), (8, 20))


def check_attn_fuse_workspace(dev):
    """K5's workspace kernel against ``attn_fuse_ref`` at ``K5_WORKSPACE``
    in float32 and bf16, timed in bf16; fails if a row did not take the
    workspace kernel (``attn_fuse.plan``)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        attn_fuse as k5,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    h, w, C = H >> 3, W >> 3, _stage_channels(16, 0)
    temp = dtu_model_config().attn_temp
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for D, G in K5_WORKSPACE:
            cors = (torch.randn((V - 1, B, D, h, w, G), generator=gen, device=dev)
                    * 0.5).to(dtype)
            args5 = (cors, temp, C)
            instance = k5.plan(B, D, h, w, G, dtype)
            if instance != "workspace":
                raise AssertionError(f"attn_fuse D {D} G {G}: took {instance}, not the workspace")
            got, want = k5.attn_fuse(*args5), k5.attn_fuse_ref(*args5)
            torch.cuda.synchronize()
            nbytes = (cors.numel() + got.numel()) * cors.element_size()
            ops = (V - 1) * B * D * h * w * (3 * G + 8) + B * D * h * w * G
            _record(rows, "attn_fuse", "eval", list(cors.shape), dtype, _max_err(got, want),
                    k5.TOLERANCE[dtype] * _scale(want), 1,
                    lambda a=args5: k5.attn_fuse(*a), lambda a=args5: k5.attn_fuse_ref(*a),
                    nbytes, ops, FP32_FLOPS, row_set="workspace",
                    timed=dtype == torch.bfloat16, instance=instance)
    return rows


def check_warp_cor_pipeline(dev):
    """K1 and K5 at one view of the float32 pipeline (B1, the eval_dtu.sh
    model's (C, G) = (64, 8), (32, 8), (16, 4), (8, 4), 3 source views), K1
    on a B1 scene's own hypotheses, timed in float32: set
    ``pipeline_float32``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = []
    _k1_rows(rows, dev, _scene(1, V, H, W, dev), gen, 8, (8, 8, 4, 4), torch.float32, "path",
             "pipeline_float32", True)
    _k5_rows(rows, dev, gen, 1, 8, (8, 8, 4, 4), torch.float32, "pipeline_float32", True)
    return rows


# K2's rows: (set, N, dtypes, modes per level, FPN base); a level's mode is
# "with_u" (o and u: the eval forward's and the train forward's mid levels),
# "o" (the last level) or "u_only" (the train step's backward re-deriving
# u). Every row is held in float32 and bf16; the set's dtype is timed: the
# eval forward (B*V images), the train step (forward and backward,
# TRAIN_B*TRAIN_V images) in bf16, one view of the float32 pipeline
# (PIPELINE_V images; its u_only rows, which the pipeline does not launch,
# time the generic kernel's phase 1 alone), and the eval forward at FPN base
# 4 and 16. A level
# at base b has Ci = 8b and Cs = Co = 4b, 2b, b.
TOPDOWN_SETS = (
    ("eval", B * V, "bfloat16", ("with_u", "with_u", "o"), 8),
    ("train", TRAIN_B * TRAIN_V, "bfloat16", ("with_u", "with_u", "o"), 8),
    ("train", TRAIN_B * TRAIN_V, "bfloat16", ("u_only",) * 3, 8),
    ("pipeline_float32", PIPELINE_V, "float32", ("with_u", "with_u", "o"), 8),
    # phase 1 alone (u_only) at the pipeline's shapes: what the 3x3 adds
    ("pipeline_float32_u_only", PIPELINE_V, "float32", ("u_only",) * 3, 8),
    *((f"eval_base{b}", B * V, "bfloat16", ("with_u", "with_u", "o"), b) for b, _ in OTHER_WIDTHS),
)


def check_topdown(dev):
    """K2 against ``topdown_level_ref`` at every level of each of
    ``TOPDOWN_SETS``, in float32 and bf16, with the set's dtype timed. The
    bound counts intra and skip read once, o and u (where written) written
    once and the weights; operations at the bf16 tensor-core rate in bf16,
    at the float32 CUDA-core rate in float32. A row's ``instance`` names
    the route its shape takes: the tensor cores or the generic kernel."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        topdown as k2,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for row_set, N, timed_dtype, modes, base in TOPDOWN_SETS:
        ci = 8 * base
        for dtype in (torch.float32, torch.bfloat16):
            for lvl, mode in enumerate(modes):
                cs = co = (4 * base) >> lvl
                hh, wh = H >> (3 - lvl), W >> (3 - lvl)
                intra = torch.randn((N, hh, wh, ci), generator=gen, device=dev).to(dtype)
                skip = torch.randn((N, 2 * hh, 2 * wh, cs), generator=gen, device=dev).to(dtype)
                wi = torch.randn((ci, cs, 1, 1), generator=gen, device=dev) * cs ** -0.5
                bi = torch.randn((ci,), generator=gen, device=dev) * 0.1
                wo = torch.randn((co, ci, 3, 3), generator=gen, device=dev) * (9 * ci) ** -0.5
                kw = {"with_u": mode == "with_u", "u_only": mode == "u_only"}
                args = (intra, skip, wi, bi, wo)
                got, want = k2.topdown_level(*args, **kw), k2.topdown_level_ref(*args, **kw)
                torch.cuda.synchronize()
                got, want = (got, want) if mode == "with_u" else ((got,), (want,))
                err = max(_max_err(a, b) for a, b in zip(got, want))
                tol = k2.TOLERANCE[dtype] * max(_scale(b) for b in want)
                esz = intra.element_size()
                npix = N * 4 * hh * wh
                written = (0 if mode == "u_only" else co) + (0 if mode == "o" else ci)
                nbytes = (intra.numel() + skip.numel() + npix * written) * esz \
                    + (wi.numel() + bi.numel() + (0 if mode == "u_only" else wo.numel())) * 4
                ops = npix * (ci * (2 * cs + 7) + (0 if mode == "u_only" else 2 * 9 * ci * co))
                is_bf16 = dtype == torch.bfloat16
                mma = (is_bf16 and ci == k2.MMA_CI and cs in k2.MMA_CHANNELS
                       and co in k2.MMA_CHANNELS)
                _record(rows, "topdown", row_set.split("_")[0], [N, 2 * hh, 2 * wh, cs, co], dtype,
                        err, tol, 1, lambda a=args, k=kw: k2.topdown_level(*a, **k),
                        lambda a=args, k=kw: k2.topdown_level_ref(*a, **k), nbytes, ops,
                        BF16_TENSOR_FLOPS if is_bf16 else FP32_FLOPS, row_set=row_set,
                        timed=str(dtype) == f"torch.{timed_dtype}", mode=mode, ci=ci,
                        instance="tensor cores" if mma else "generic")
    return rows


def _band_conv_args(dev, gen, n, h, w, ci, co, dtype):
    """K6's inputs at one layer: x, a random weight and an eval BatchNorm
    with random statistics folded into scale and bias; and that BatchNorm
    (the unfused route's)."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
        TorchBatchNorm,
    )

    x = torch.randn((n, h, w, ci), generator=gen, device=dev).to(dtype)
    wt = torch.randn((co, ci, 3, 3), generator=gen, device=dev) * (9 * ci) ** -0.5
    bn = TorchBatchNorm(co).to(dev).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(co, generator=gen, device=dev) * 1.5 + 0.5)
        bn.bias.copy_(torch.randn(co, generator=gen, device=dev) * 0.2)
        bn.running_mean.copy_(torch.randn(co, generator=gen, device=dev) * 0.2)
        bn.running_var.copy_(torch.rand(co, generator=gen, device=dev) * 1.5 + 0.5)
        scale, bias = bn.folded()
    return (x, wt, scale, bias), bn


def check_band_conv(dev):
    """K6 against ``band_conv_ref`` at every layer of ``_band_conv_layers``
    in each of ``BAND_CONV_SETS``, with random weights, folded scale and
    bias, and the times of the kernel, the plain version, the library
    yardstick (``F.conv2d`` on the folded weight and bias, then in-place
    ``relu_``) and the unfused route K6 replaces (cuDNN conv,
    ``TorchBatchNorm`` in eval, ``F.relu``). The bound counts x read and
    the output written once; operations at the bf16 tensor-core rate in
    bf16, at the float32 CUDA-core rate in float32. A row's ``instance`` is
    its route and launch shape (``band_conv.plan``)."""
    import torch
    import torch.nn.functional as F

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
        band_conv_route,
        conv2d_nhwc,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        band_conv as k6,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = []
    for row_set, batch, dtype_name in BAND_CONV_SETS:
        dtype = getattr(torch, dtype_name)
        layers_of = [(row_set, r) for r in _band_conv_layers(batch)]
        if row_set.startswith("eval"):
            layers_of += [(f"asff_{row_set}", r) for r in _asff_band_conv_layers(batch)]
        for rset, (name, n, h, w, ci, co, layers) in layers_of:
            per_run = layers if band_conv_route(ci, co, dtype) else 0
            args, bn = _band_conv_args(dev, gen, n, h, w, ci, co, dtype)
            x, wt, scale, bias = args
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
            is_bf16 = dtype == torch.bfloat16
            with torch.no_grad():
                _record(rows, "band_conv", "eval", [n, h, w, ci, co], dtype,
                        _max_err(got, want), k6.TOLERANCE[dtype] * _scale(want), per_run,
                        lambda a=args: k6.band_conv(*a), lambda a=args: k6.band_conv_ref(*a),
                        nbytes, 2 * n * h * w * co * 9 * ci,
                        BF16_TENSOR_FLOPS if is_bf16 else FP32_FLOPS, run_library,
                        run_unfused, row_set=rset, timed=True, layers=layers,
                        instance=k6.plan(n, h, w, ci, co, dtype))
            rows[-1]["layer"] = name
    return rows


def _path_hypotheses(batch, cfg):
    """The four stages' hypotheses as the train and eval paths make them
    from a depth map (the batch's B): stage 1 the full inverse range
    (``init_inverse_range``), each later stage ``schedule_inverse_range``
    around the scene's depth at the previous stage, +- ``depth_inter_r`` of
    that stage's spacing, as ``models/stagenet.py`` and
    ``models/mvs4net.py`` compute it."""
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


def check_warp_bwd(dev, batch, base=8, hypotheses=("full_range", "train"), suffix=""):
    """K3 against ``warp_bwd_ref`` at the train step's four stages (B=6,
    the stage's C at FPN base ``base`` and D, 4 source views each), with g
    in float32 and bf16, on the ``hypotheses`` sets (row set: the name and
    ``suffix``): ``full_range`` (the full inverse range at every stage,
    jittered, the worst case for the footprint) and the train path's
    (``train``: ``_path_hypotheses``); a row's ``instance`` names K3's
    float4 or scalar atomics; in bf16 the times
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

    cfg = dtu_model_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2 + base)
    rows, library_diff = [], {}
    Bt = TRAIN_B
    train_hypos = _path_hypotheses(batch, cfg)
    for hyps in hypotheses:
        row_set = hyps + suffix
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(4):
                h, w = H >> (3 - s), W >> (3 - s)
                C, D = _stage_channels(base, s), cfg.ndepths[s]
                projs = batch["proj_matrices"][f"stage{s + 1}"]
                rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
                if hyps == "train":
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
                        row_set=row_set,
                        instance="float4" if C % k3.FAST_CHANNEL_MULTIPLE == 0 else "scalar")
    return rows, library_diff


def check_warp_fwd(dev, batch, base=8, sets=(("train", "train"), ("full_range", "full_range"))):
    """K4 against ``warp_fwd_ref`` at the train step's four stages (B=6,
    the stage's C at FPN base ``base`` and D, 4 source views each), in
    float32 and bf16, on each ``(hypotheses, row set)`` of ``sets``: the
    train path's (``train``: ``_path_hypotheses``) or the full inverse range
    at every stage, jittered (``full_range``, the widest footprint). Raises
    unless K4 equals its plain version bit for bit (``bit_equal``) and is
    within the tolerance. A row's ``instance`` is the launch shape the kernel takes
    (``warp_fwd.plan``); in bf16
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

    cfg = dtu_model_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4 + base)
    rows, library_diff = [], {}
    Bt = TRAIN_B
    path_hypos = _path_hypotheses(batch, cfg)
    for hyps, row_set in sets:
        for dtype in (torch.float32, torch.bfloat16):
            for s in range(4):
                h, w = H >> (3 - s), W >> (3 - s)
                C, D = _stage_channels(base, s), cfg.ndepths[s]
                projs = batch["proj_matrices"][f"stage{s + 1}"]
                rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
                if hyps == "train":
                    hypo = path_hypos[s]
                else:
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
                    library_diff[f"{row_set} stage{s + 1}"] = _max_err(lib, want)
                # the source, hypotheses and projection read once, the warped
                # volume written once; per output element 4 products and 3 sums,
                # per pixel the coordinates (~28 operations, as K1's)
                nbytes = src.numel() * src.element_size() + hypo.numel() * 4 \
                    + rel.numel() * 4 + got.numel() * got.element_size()
                bit_equal = bool(torch.equal(got, want))
                if not bit_equal:
                    raise AssertionError(f"warp_fwd {[Bt, D, h, w, C]} {dtype} {row_set}: "
                                         "not bit-equal to warp_fwd_ref")
                _record(rows, "warp_fwd", "train", [Bt, D, h, w, C], dtype,
                        _max_err(got, want), k4.TOLERANCE[dtype] * _scale(want), TRAIN_V - 1,
                        lambda a=(src, rel, hypo): k4.warp_fwd(*a),
                        lambda a=(src, rel, hypo): k4.warp_fwd_ref(*a),
                        nbytes, Bt * D * h * w * (28 + 7 * C), FP32_FLOPS, run_library,
                        row_set=row_set, hypotheses=hyps, bit_equal=bit_equal,
                        instance=k4.plan(Bt, D, h, w, C))
    return rows, library_diff


def profile_run(fn):
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``:
    the total, the device's busy share of the call's wall time, the share
    of each of the port's kernels and of the convolution library (cuDNN's
    and CUTLASS's convolutions and GEMMs: ``share_conv_library``), sorted
    by ``tools/trace_table.py:category``, and the ten largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools import trace_table

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
    cats = trace_table.by_category((k, ms) for k, ms, _ in kernels)
    total = sum(cats.values())

    def share(*labels):
        return sum(cats[c] for c in labels) / total if total else 0.0

    return {
        "device_ms": total, "wall_ms": wall_ms,
        "device_busy_share": total / wall_ms if wall_ms else 0.0,
        **{f"share_{name}": share(label) for name, label in trace_table.PORT_KERNELS.items()},
        "share_conv_library": share("conv_library", "gemm"),
        "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                for k, ms, n in sorted(kernels, key=lambda x: -x[1])[:10]],
    }


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

    model = MVS4Net(dtu_model_config(), device=dev,
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
    prof = profile_run(lambda: step(batch))
    train = {
        "B": TRAIN_B, "V": TRAIN_V, "H": H, "W": W, "dtype": "bfloat16",
        "ms_per_step": ms, "ms_per_step_rounds": round_ms, "samples_per_s": TRAIN_B * 1e3 / ms,
        "loss_per_step": losses, "launches_per_step": counts, "timed_steps": reps * rounds,
        "peak_memory_gb": peak_gb,
    }
    return train, prof, counts


def drive_pipeline(dev, counters):
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
    prof = profile_run(lambda: checks.run_pipeline(model, ds, dev))
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


def drive_variants(dev, batch, train_batch, counters):
    """Every model variant of ``checks.VARIANTS`` (the flagship with one
    change) on the card, one JSON line each:

    1. the eval forward at B4 V4 512x640 bf16 (weights and BatchNorm
       statistics from ``checks.seeded_model``): the counters set to 0 just
       before one forward and read just after, held to the variant's
       launches (K1 12, K2 3, K5 4, K6 by ``_k6_launches``); finite depth of
       the expected shape; three rounds of five timed forwards, the peak
       memory, and the device time of one forward by ``profile_run``;
    2. the DTU train step (B6 V5 512x640 bf16, recipe loss, Adam): the
       counters around one step, held to ``TRAIN_LAUNCHES``; a finite,
       present gradient on every parameter; a warm-up step and three timed
       steps, the peak memory;
    3. the small float32 checks against the CPU: ``checks.check_forward``
       and ``checks.check_train_step`` with the variant.

    Returns the launches of each kernel summed over the counted forwards
    and steps."""
    import dataclasses

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )

    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    totals = {name: 0 for name in counters}

    def counted(fn):
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
        for name, n in counts.items():
            totals[name] += n
        return out, counts

    for name, variant in checks.VARIANTS:
        cfg = dataclasses.replace(dtu_model_config(), **variant)
        want = {**EVAL_LAUNCHES, "band_conv": _k6_launches(torch.bfloat16, variant)}
        model = checks.seeded_model(cfg, SEED, dev)
        with torch.inference_mode():
            model(*args)                                       # warm-up
            out, counts = counted(lambda: model(*args))        # the variant's path
            if counts != want:
                raise AssertionError(f"{name}: launches per forward {counts}, want {want}")
            depth = out["stage4"]["depth"]
            if tuple(depth.shape) != (B, H, W) or not torch.isfinite(depth).all():
                raise AssertionError(f"{name}: stage-4 depth {tuple(depth.shape)} not "
                                     "finite/shaped")
            del out, depth
            torch.cuda.reset_peak_memory_stats()
            round_ms = [_time_ms(lambda: model(*args), 5) for _ in range(3)]
            eval_peak = torch.cuda.max_memory_allocated() / 1e9
            prof = profile_run(lambda: model(*args))
        del model
        torch.cuda.empty_cache()

        model = MVS4Net(cfg, device=dev, generator=torch.Generator().manual_seed(SEED + 5))
        step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                               lambda i: 1e-3)
        torch.cuda.reset_peak_memory_stats()
        scalars, train_counts = counted(lambda: step(train_batch))   # the variant's path
        if train_counts != TRAIN_LAUNCHES:
            raise AssertionError(f"{name}: launches per train step {train_counts}, "
                                 f"want {TRAIN_LAUNCHES}")
        for pname, p in model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"{name} {pname}: gradient missing or not finite")
        losses = [scalars["loss"].item(), step(train_batch)["loss"].item()]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        timed = [step(train_batch)["loss"] for _ in range(3)]
        end.record()
        end.synchronize()
        losses += [x.item() for x in timed]
        if not all(x == x and abs(x) != float("inf") for x in losses):
            raise AssertionError(f"{name}: train losses not finite: {losses}")
        train_peak = torch.cuda.max_memory_allocated() / 1e9
        del model, step, scalars
        torch.cuda.empty_cache()

        print(json.dumps({"variant": {
            "name": name, "fields": variant,
            "eval": {"B": B, "V": V, "H": H, "W": W, "dtype": "bfloat16",
                     "ms_per_forward": sorted(round_ms)[1], "ms_per_forward_rounds": round_ms,
                     "device_ms": prof["device_ms"],
                     "device_busy_share": prof["device_busy_share"],
                     "top": prof["top"][:5], "launches_per_forward": counts,
                     "peak_memory_gb": eval_peak},
            "train": {"B": TRAIN_B, "V": TRAIN_V, "H": H, "W": W, "dtype": "bfloat16",
                      "ms_per_step": start.elapsed_time(end) / 3, "loss_per_step": losses,
                      "launches_per_step": train_counts, "peak_memory_gb": train_peak},
            "small_forward_vs_cpu_float32": checks.check_forward(dev, seed=SEED + 1,
                                                                 variant=variant),
            "small_train_step_vs_cpu_float32": checks.check_train_step(dev, variant=variant),
        }}), flush=True)
    return totals


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

    def part(extra, train_graphs, val_graphs):
        # the CLI's steps are captured: each graph's first call launches
        # every kernel twice (its eager warm-up and its capture), and its
        # replays launch none
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = cli.main(TRAIN_CLI_FLAGS + extra)
        seconds = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in counters.items()}
        want = {name: 2 * (train_graphs * TRAIN_LAUNCHES[name] + val_graphs * VAL_LAUNCHES[name])
                for name in counters}
        if counts != want:
            raise AssertionError(f"train CLI {extra}: launches {counts}, want {want}")
        return out, counts, seconds

    state, counts_fit, s_fit = part(["--epochs", "1"], 1, 1)
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
    state, counts_resume, s_resume = part(["--epochs", "2", "--resume"], 1, 1)
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
    avg, counts_test, s_test = part(["--mode", "test"], 0, 1)
    if not np.isfinite(avg["loss"]):
        raise AssertionError(f"--mode test: loss {avg['loss']}")
    prof, counts_profile, s_profile = part(["--mode", "profile"], 1, 0)
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
        # per captured step: the counted launches of its capture (half of
        # the first call's, the other half the warm-up's)
        "launches_per_train_step": {k: v / 2 for k, v in counts_profile.items()},
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


# the space phase: (run, B, V, H, W, dtype, shard counts); the flagship
# eval in both dtypes, and a Tanks&Temples-sized view (1024x1920, 5 views,
# data/tanks.py) in bf16; the halo is the CLI's default
SPACE_RUNS = (("flagship", B, V, H, W, "float32", (2, 4)),
              ("flagship", B, V, H, W, "bfloat16", (2, 4)),
              ("tanks", 1, 5, 1024, 1920, "bfloat16", (4,)))
SPACE_HALO = 48


def _window_rows(rows, dev, gen, batch, cfg, S, dtype, row_set, stages):
    """K1, K5 and K6 against their plain versions at the row windows of
    ``stages`` (the windowed stages of an ``S``-way row-sharded forward of
    ``batch``), on the window of rank ``S // 2``: K1 with the stage's whole
    source view, the window's reference features and hypotheses and the
    reference principal point moved up by the window start; K5 on the
    window's V-1 volumes; K6 at Reg2D.conv0 of the window. Each row's
    launches per run are its launches per sharded forward (S windows)."""
    import torch
    import torch.nn.functional as F

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
        relative_projection,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
        band_conv_route,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.mvs4net import (
        _row_window,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        attn_fuse as k5,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        band_conv as k6,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        warp_cor as k1,
    )

    nb, nv, img_h, img_w = batch["imgs"].shape[:4]
    for s in stages:
        h, w = img_h >> (3 - s), img_w >> (3 - s)
        start, ws, _, _ = _row_window(h, S // 2, S, SPACE_HALO)
        C, G, D = _stage_channels(cfg.fpn_base_channel, s), cfg.group_cor_dim[s], cfg.ndepths[s]
        projs = batch["proj_matrices"][f"stage{s + 1}"].clone()
        projs[:, 0, 1, 1, 2] -= start
        rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
        hypo = _jittered_hypo(batch["depth_values"], D, h, w, gen)[:, :, start:start + ws]
        hypo = hypo.contiguous()
        src = torch.randn((nb, h, w, C), generator=gen, device=dev).to(dtype)
        ref = torch.randn((nb, ws, w, C), generator=gen, device=dev).to(dtype)
        args = (src, ref, rel, hypo, G)
        got, want = k1.warp_cor(*args), k1.warp_cor_ref(*args)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in args[:4]) \
            + got.numel() * got.element_size()
        _record(rows, "warp_cor", "space", [nb, D, ws, w, C, G], dtype, _max_err(got, want),
                k1.TOLERANCE[dtype] * _scale(want), S * (nv - 1),
                lambda a=args: k1.warp_cor(*a), lambda a=args: k1.warp_cor_ref(*a),
                nbytes, nb * D * ws * w * (28 + 9 * C + G), FP32_FLOPS, row_set=row_set,
                timed=True, src_rows=h, instance=k1.plan(nb, D, ws, w, C, G, h, w))
        cors = (torch.randn((nv - 1, nb, D, ws, w, G), generator=gen, device=dev) * 0.5)
        args5 = (cors.to(dtype), cfg.attn_temp, C)
        got, want = k5.attn_fuse(*args5), k5.attn_fuse_ref(*args5)
        torch.cuda.synchronize()
        _record(rows, "attn_fuse", "space", list(cors.shape), dtype, _max_err(got, want),
                k5.TOLERANCE[dtype] * _scale(want), S,
                lambda a=args5: k5.attn_fuse(*a), lambda a=args5: k5.attn_fuse_ref(*a),
                (cors.numel() + got.numel()) * args5[0].element_size(),
                (nv - 1) * nb * D * ws * w * (3 * G + 8) + nb * D * ws * w * G, FP32_FLOPS,
                row_set=row_set, timed=True, instance=k5.plan(nb, D, ws, w, G, dtype))
        co = cfg.reg_channel
        args6, _ = _band_conv_args(dev, gen, nb * D, ws, w, G, co, dtype)
        got, want = k6.band_conv(*args6), k6.band_conv_ref(*args6)
        torch.cuda.synchronize()
        x, wt, scale, bias = args6
        # the library yardstick, as check_band_conv's: F.conv2d on the
        # folded weight and bias, then relu_
        w_lib, b_lib = (wt * scale[:, None, None, None]).to(dtype), bias.to(dtype)

        def run_library(x_nchw=x.permute(0, 3, 1, 2), w_lib=w_lib, b_lib=b_lib):
            return F.conv2d(x_nchw, w_lib, b_lib, 1, 1).relu_()

        with torch.no_grad():
            _record(rows, "band_conv", "space", [nb * D, ws, w, G, co], dtype,
                    _max_err(got, want), k6.TOLERANCE[dtype] * _scale(want),
                    S if band_conv_route(G, co, dtype) else 0,
                    lambda a=args6: k6.band_conv(*a), lambda a=args6: k6.band_conv_ref(*a),
                    (x.numel() + got.numel()) * x.element_size() + (wt.numel() + 2 * co) * 4,
                    2 * nb * D * ws * w * co * 9 * G,
                    BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS, run_library,
                    row_set=row_set, timed=True, instance=k6.plan(nb * D, ws, w, G, co, dtype))
        rows[-1]["layer"] = f"Reg2D.conv0 stage{s + 1} window"


def drive_space(dev, counters, rows):
    """The row-sharded eval (``--space``) on one card: per run of
    ``SPACE_RUNS``, the unsharded forward counted and timed, then for each
    shard count S ``parallel.mesh.sharded_eval_forward`` over
    ``[card] * S`` (the windows' arithmetic, not multi-card speed): the
    counters set to 0 just before one forward and read just after (S times
    the unsharded forward's launches), every stage held to the unsharded
    forward (``checks.compare_space``), ms per forward from the host (the
    median of three) and between CUDA events (three back to back), the
    device time of one profiled forward (``profile_run``) and its busy
    share, peak memory; then K1, K5 and K6 at the window shapes
    against their plain versions (``_window_rows``, appended to ``rows``).
    Returns the phase's line and the launches of the counted forwards."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.mvs4net import (
        _row_window,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
        sharded_eval_forward,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    totals = {name: 0 for name in counters}
    runs = []

    def counted(fn):
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
        for name, n in counts.items():
            totals[name] += n
        return out, counts

    for name, nb, nv, img_h, img_w, dtype_name, shard_counts in SPACE_RUNS:
        dtype = getattr(torch, dtype_name)
        cfg = dtu_model_config(dtype_name)
        model = checks.seeded_model(cfg, SEED, dev)
        batch = _scene(nb, nv, img_h, img_w, dev)
        args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        dv = batch["depth_values"]
        depth_range = (dv[:, -1] - dv[:, 0]).max().item()
        with torch.inference_mode():
            model(*args)
            want, whole_counts = counted(lambda: model(*args))
            torch.cuda.reset_peak_memory_stats()
            whole_ms = _time_ms(lambda: model(*args), 3)
            whole_peak = torch.cuda.max_memory_allocated() / 1e9
        for S in shard_counts:
            fwd = sharded_eval_forward(model, [dev] * S, space=S, space_halo=SPACE_HALO)
            fwd(*args)                                             # warm-up
            torch.cuda.reset_peak_memory_stats()
            got, counts = counted(lambda: fwd(*args))              # the space path
            expect = {k: S * n for k, n in whole_counts.items()}
            if counts != expect:
                raise AssertionError(f"space {name} S{S}: launches {counts}, want {expect}")
            peak = torch.cuda.max_memory_allocated() / 1e9
            agreement = checks.compare_space(got, want, dtype, depth_range,
                                             what=f"space {name} {dtype_name} S{S}")
            del got
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fwd(*args)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            events_ms = _time_ms(lambda: fwd(*args), 3)
            prof = profile_run(lambda: fwd(*args))
            stages = [s for s in range(4)
                      if _row_window(img_h >> (3 - s), 0, S, SPACE_HALO) is not None]
            windows, copy_bytes = {}, 0
            elt = torch.finfo(dtype).bits // 8
            for s in stages:
                h, w = img_h >> (3 - s), img_w >> (3 - s)
                ws = _row_window(h, 0, S, SPACE_HALO)[1]
                windows[f"stage{s + 1}"] = ws
                C, D = _stage_channels(cfg.fpn_base_channel, s), cfg.ndepths[s]
                copy_bytes += S * nb * ws * w * (C * elt + D * 4)
            row_set = f"space_{name}_S{S}_{dtype_name}"
            _window_rows(rows, dev, gen, batch, cfg, S, dtype, row_set, stages)
            runs.append({
                "run": name, "B": nb, "V": nv, "H": img_h, "W": img_w, "dtype": dtype_name,
                "S": S, "halo": SPACE_HALO, "window_rows": windows,
                "ms_per_forward_host": sorted(host)[1], "ms_per_forward_events": events_ms,
                "device_ms": prof["device_ms"], "device_busy_share": prof["device_busy_share"],
                "kernel_shares": {k: prof[f"share_{k}"] for k in counters},
                "unsharded_ms_per_forward": whole_ms, "peak_memory_gb": peak,
                "unsharded_peak_memory_gb": whole_peak,
                "launches_per_forward": counts, "launches_per_rank":
                    {k: n / S for k, n in counts.items()},
                "window_copy_bytes_per_forward": copy_bytes,
                "vs_unsharded": agreement, "row_set": row_set,
            })
        del model, batch, args, want
        torch.cuda.empty_cache()
    return {"devices": "one card, [cuda:0] * S", "runs": runs}, totals


DP_STEPS = 3
TORCHRUN_LOGDIR = TRAIN_CLI_LOGDIR + "_torchrun"


def drive_ddp(dev, batch, counters):
    """Data-parallel training on one card: a world of one rank over NCCL
    (a ``file://`` store in a temporary directory); ``checks.check_ddp_step``
    on the DTU recipe (B6 V5 512x640 bf16, ``DP_STEPS`` steps of each
    ``dp_impl`` against ``checks.DDP_BARE_RUNS`` runs of the bare
    ``TrainStep`` from the same seed, whose gaps from each other are the
    step's run-to-run noise); the counters set to 0 before and read after
    (every step ``TRAIN_LAUNCHES``). Then
    ``torchrun --standalone --nproc_per_node 1`` runs the train CLI for one
    epoch on ``synthetic://512x640/12`` (``TRAIN_CLI_FLAGS``), which joins
    an NCCL group of one rank and trains through ``data_parallel``."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.distributed import (
        run_torchrun,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import DP_IMPLS

    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        def make_model():
            return MVS4Net(dtu_model_config(), device=dev,
                           generator=torch.Generator().manual_seed(SEED + 5))

        for mod in counters.values():
            mod.launches = 0
        check = checks.check_ddp_step(dev, make_model, batch, DP_STEPS, DP_IMPLS)
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in counters.items()}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    runs = checks.DDP_BARE_RUNS + len(DP_IMPLS)
    want = {k: runs * DP_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"ddp: launches {counts}, want {want}")

    shutil.rmtree(TORCHRUN_LOGDIR, ignore_errors=True)
    flags = list(TRAIN_CLI_FLAGS)
    flags[flags.index("--logdir") + 1] = TORCHRUN_LOGDIR
    t0 = time.perf_counter()
    run_torchrun(f"{PKG}.cli.train", [*flags, "--epochs", "1"], 1, 600)
    torchrun_s = time.perf_counter() - t0
    records = _read_records(os.path.join(TORCHRUN_LOGDIR, "metrics.jsonl"))
    if [(r["mode"], r["step"]) for r in records] != [
            ("train", 0), ("train", 1), ("test", 0), ("test", 1), ("fulltest", 2)] \
            or not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"torchrun train CLI records {records}")
    for name in os.listdir(TORCHRUN_LOGDIR):
        if name.endswith(".ckpt"):
            os.remove(os.path.join(TORCHRUN_LOGDIR, name))
    return {"world": 1, "backend": "nccl", "B": TRAIN_B, "V": TRAIN_V, "H": H, "W": W,
            "dtype": "bfloat16", **check, "launches": counts,
            "torchrun": {"seconds": torchrun_s,
                         "loss_per_step": [r["loss"] for r in records if r["mode"] == "train"],
                         "step_ms": [r["step_s"] * 1e3 for r in records
                                     if r["mode"] == "train"],
                         "fulltest_loss": records[-1]["loss"]}}, counts


def _eval_fixture(root, V, H, W, seed=5):
    """An eval-layout scene (``--dataset_name dtu``) on disk: a plane
    scene's rectified images (PNG, Pillow), one cam file per view, the pair
    file and the test list."""
    import numpy as np
    from PIL import Image

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import io
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        make_plane_scene,
    )

    sc = make_plane_scene(V=V, H=H, W=W, seed=seed)
    os.makedirs(os.path.join(root, "Rectified_raw", "scan1"))
    os.makedirs(os.path.join(root, "Cameras"))
    for v in range(V):
        Image.fromarray((sc["imgs"][v] * 255).round().astype(np.uint8)).save(
            os.path.join(root, "Rectified_raw", "scan1", f"rect_{v + 1:0>3}_3_r5000.png"))
        io.write_cam_file(os.path.join(root, "Cameras", f"{v:0>8}_cam.txt"), sc["extrinsics"][v],
                          sc["intrinsics"], [425.0, (935.0 - 425.0) / 192])
    io.write_pair_file(os.path.join(root, "pair.txt"),
                       [(v, [s for s in range(V) if s != v]) for v in range(V)])
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("scan1\n")


def drive_debug(dev, counters):
    """The eval CLI with ``--debug_model 255`` at the pipeline's shape
    (``cli.test.main`` in this process: the scripts/eval_dtu.sh model in
    float32 with the CLI's seed-0 weights, ``--run_gendepth`` over an
    eval-layout scene of 4 views at 512x640, ``_eval_fixture``), on the card
    with the counters set to 0 before and read after (the 4 views' forwards
    and the dump's: its forward's launches, and K4 for each warped view of
    bit 5 and each correlation of bit 6), and with ``--device cpu``; the
    card's dumps held to the CPU's (``checks.compare_debug_dumps``). The
    scene and the outputs live in a temporary directory (the dumps are
    hundreds of MB at this size) and are removed."""
    import glob
    import shutil
    import tempfile

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as eval_cli

    root = tempfile.mkdtemp()
    try:
        data = os.path.join(root, "scene")
        _eval_fixture(data, PIPELINE_V, H, W)
        flags = ["--dataset=dataloader_eval", "--dataset_name=dtu", "--datapath", data,
                 "--testlist", os.path.join(data, "test.txt"), "--interval_scale", "1.0",
                 "--max_h", str(H), "--max_w", str(W), "--num_worker", "0",
                 "--group_cor", "--group_cor_dim", "8,8,4,4", "--ndepths", "8,8,4,4",
                 "--depth_inter_r", "0.5,0.5,0.5,1", "--inverse_depth", "--attn_temp", "2",
                 "--run_gendepth", "--NviewGen", str(PIPELINE_V), "--debug_model", "255"]
        written, seconds, counts = {}, {}, None
        for key, extra in (("cpu", ["--device", "cpu"]), ("card", [])):
            out = os.path.join(root, key)
            if key == "card":
                torch.cuda.synchronize()
                for mod in counters.values():
                    mod.launches = 0
            t0 = time.perf_counter()
            eval_cli.main(flags + ["--outdir", out] + extra)
            seconds[key] = time.perf_counter() - t0
            if key == "card":
                torch.cuda.synchronize()
                counts = {name: mod.launches for name, mod in counters.items()}
            written[key] = {os.path.basename(p)[len("eval_scan1_"):-len(".npy")]: p
                            for p in glob.glob(os.path.join(out, "debug", "eval_scan1_*.npy"))}
        # the views' captured forward: its first call's warm-up and capture
        # (the other views replay); then the dump's eager forward
        want = {k: 3 * n for k, n in PIPELINE_LAUNCHES_PER_VIEW.items()}
        want["warp_fwd"] += 2 * 4 * (PIPELINE_V - 1)
        if counts != want:
            raise AssertionError(f"debug dump: launches {counts}, want {want}")
        agreement = checks.compare_debug_dumps(written["card"], written["cpu"], str(dev))
        nbytes = sum(os.path.getsize(p) for p in written["card"].values())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"B": 1, "V": PIPELINE_V, "H": H, "W": W, "dtype": "float32", "bits": 255,
            "views": PIPELINE_V, "arrays": len(written["card"]), "bytes": nbytes,
            "cli_seconds": seconds, "launches": counts, "vs_cpu": agreement}, counts


# the drivers phase: each driver's limit, and the demo's reported steps
DRIVER_TIMEOUT_S = 600
DEMO_STEPS = (0, 10, 50, 100, 200, 299)


def _run_driver(module, *args):
    """``python -m <port>.<module> args`` to its end; its standard output's
    lines. Raises on a non-zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"{PKG}.{module}", *args],
                         capture_output=True, text=True, timeout=DRIVER_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f"{module} rc {res.returncode}: {(res.stdout + res.stderr)[-3000:]}")
    return res.stdout.strip().splitlines(), time.perf_counter() - t0


def drive_drivers(dev, counters):
    """The port's drivers as a user runs them: ``bench`` at its pinned values
    (its last line held to the metric's keys: a positive rate, three groups,
    the card's name); one forward of ``graft_entry.entry()``'s ``fn`` at the
    bench shape, the counters set to 0 just before and read just after
    (twice ``EVAL_LAUNCHES``: the call captures, its warm-up and its capture
    each launching every kernel; a second call replays and counts none),
    its depth finite; ``scripts/bench_scaling.py`` (one
    card: the one-rank row and its set-up split); ``graft_entry 1`` (the
    dry run on one rank); ``tools/train_demo.py`` for its 300 steps (six
    finite scalar lines)."""
    import math

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import bench, graft_entry

    out = {}
    lines, out["bench_s"] = _run_driver("bench")
    line, detail = json.loads(lines[-1]), json.loads(lines[-2])["bench"]
    if (line["metric"] != bench.METRIC or not line["value"] > 0
            or len(line["groups_maps_per_s"]) != bench.GROUPS or line["vs_baseline"] != 1.0
            or not line["device"] or "spread_maps_per_s" not in line):
        raise AssertionError(f"bench line {line}")
    out["bench"], out["bench_detail"] = line, detail

    fn, _ = graft_entry.entry(dev)
    batch = graft_entry.example_batch(B, V, H, W, device=dev)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    depth, conf = fn(*args)          # the entry path, counted: its first call captures
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, mod in counters.items()}
    want = {k: 2 * n for k, n in EVAL_LAUNCHES.items()}   # the warm-up's and the capture's
    if counts != want:
        raise AssertionError(f"entry(): launches of its first call {counts}, want {want}")
    before = {name: mod.launches for name, mod in counters.items()}
    fn(*args)                        # a replay: no wrapper runs
    torch.cuda.synchronize()
    if any(mod.launches != before[name] for name, mod in counters.items()):
        raise AssertionError("entry(): a replay ran a kernel wrapper")
    if tuple(depth.shape) != (B, H, W) or not torch.isfinite(depth).all():
        raise AssertionError(f"entry(): stage-4 depth {tuple(depth.shape)} not finite/shaped")
    out["entry"] = {"B": B, "V": V, "H": H, "W": W, "launches": counts,
                    "depth_mean": depth.float().mean().item(),
                    "confidence_finite_share": torch.isfinite(conf).float().mean().item()}
    del fn, batch, args, depth, conf
    torch.cuda.empty_cache()

    lines, out["scaling_s"] = _run_driver("scripts.bench_scaling")
    setup, row = json.loads(lines[-2])["setup"], json.loads(lines[-1])
    if row["devices"] != 1 or row["scaling_efficiency"] != 1.0 or not row["step_s"] > 0:
        raise AssertionError(f"bench_scaling row {row}")
    out["scaling"], out["scaling_setup"] = row, setup

    lines, out["dryrun_s"] = _run_driver("graft_entry", "1")
    if not lines[-1].startswith("dryrun_multichip(1) ok: "):
        raise AssertionError(f"dry run: {lines[-3:]}")
    out["dryrun"] = lines[-1]

    lines, out["train_demo_s"] = _run_driver("tools.train_demo")
    steps = [x for x in lines if x.startswith("step ")]
    scalars = [[float(v.split("=")[1].rstrip("%")) for v in x.split(": ")[1].split()]
               for x in steps]
    if ([int(x.split(":")[0].split()[1]) for x in steps] != list(DEMO_STEPS)
            or not all(math.isfinite(v) for row in scalars for v in row)):
        raise AssertionError(f"train demo: {lines}")
    out["train_demo"] = lines
    return out, counts



def drive_graphs(dev, counters, eager_pipeline, drivers):
    """The captured entry points (``utils/graphs.py``, the port's ``jax.jit``)
    beside their eager forms (``graphs.eager``) in this call:

    1. the eval forward (``eval.depthgen.make_eval_forward``) at B4 V4
       512x640 bf16, eager and captured: the first call (counted: eager
       K1 12, K2 3, K5 4, K6 12; captured twice that, the warm-up's and the
       capture's launches, a replay counting none), three rounds of five
       timed calls, the device time and busy share of one call
       (``profile_run``: whether the profiler sees the kernels of a replayed
       graph), peak memory allocated and reserved (a graph's pool is
       reserved); then ``checks.check_graph_forward``: the replay bit-equal
       to the eager forward, an earlier result kept across a later call;
    2. the eval step at the DTU recipe's batch (B6 V5), replayed against
       eager, every scalar bit-equal (``checks.check_graph_eval_step``);
    3. the DTU train step (B6 V5 bf16): the captured step's first call
       (counted: twice ``TRAIN_LAUNCHES``), a warm-up step and three rounds
       of three timed steps, a profile of one replay, peak memory; then
       ``checks.check_graph_train_step``: 3 replayed steps within 4x the
       eager steps' run-to-run noise (K3's atomics);
    4. the pipeline (``checks.run_pipeline``, as ``drive_pipeline``) with
       one captured forward and captured filters: a first run that
       captures (counted), then a timed run; its fused point count equal to
       the eager run's (``eager_pipeline``);
    5. the bench's captured chain: ``drivers``' run of ``bench.py``.

    Returns the phase's line and the launches of its counted first calls."""
    import contextlib
    import gc

    import numpy as np
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        SyntheticEvalDataset,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    totals = {name: 0 for name in counters}

    def fresh():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def counted(fn, want, what):
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {name: mod.launches for name, mod in counters.items()}
        if counts != want:
            raise AssertionError(f"graphs {what}: launches {counts}, want {want}")
        for name, n in counts.items():
            totals[name] += n
        return out, counts, seconds

    def twice(launches):
        return {k: 2 * n for k, n in launches.items()}

    line = {"B": B, "V": V, "H": H, "W": W, "dtype": "bfloat16", "eval": {}, "train": {}}
    model = checks.seeded_model(dtu_model_config(), SEED, dev)
    batch = _scene(B, V, H, W, dev)
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    for mode in ("eager", "captured"):
        forward = make_eval_forward(model)
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            fresh()
            _, counts, first_s = counted(
                lambda: forward(*args),
                EVAL_LAUNCHES if mode == "eager" else twice(EVAL_LAUNCHES), f"eval {mode}")
            round_ms = [_time_ms(lambda: forward(*args), 5) for _ in range(3)]
            prof = profile_run(lambda: forward(*args))
            line["eval"][mode] = {
                "ms_per_forward": sorted(round_ms)[1], "ms_per_forward_rounds": round_ms,
                "first_call_s": first_s, "launches_first_call": counts,
                "device_ms": prof["device_ms"], "profile_wall_ms": prof["wall_ms"],
                "device_busy_share": prof["device_busy_share"],
                "shares": {k: v for k, v in prof.items() if k.startswith("share_")},
                "top": prof["top"][:5],
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                "graphs": len(forward.graphs)}
        del forward
    eager, captured = line["eval"]["eager"], line["eval"]["captured"]
    if captured["graphs"] != 1 or eager["graphs"] != 0:
        raise AssertionError(f"eval graphs: eager {eager['graphs']}, captured "
                             f"{captured['graphs']}")
    # the profiler sees a replay's kernels where its device time is the
    # eager call's (the same kernels)
    line["eval"]["profiler_sees_replayed_kernels"] = (
        captured["device_ms"] > 0.5 * eager["device_ms"])
    line["eval"]["vs_eager"] = checks.check_graph_forward(model, *args)
    del model, batch, args
    fresh()

    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    line["eval_step"] = checks.check_graph_eval_step(
        checks.seeded_model(dtu_model_config(), SEED, dev), train_batch)

    def make_model():
        return MVS4Net(dtu_model_config(), device=dev,
                       generator=torch.Generator().manual_seed(SEED + 5))

    model = make_model()
    step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    fresh()
    scalars, counts, first_s = counted(lambda: step(train_batch), twice(TRAIN_LAUNCHES),
                                       "train step")
    losses = [scalars["loss"].item(), step(train_batch)["loss"].item()]
    round_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = [step(train_batch)["loss"] for _ in range(3)]
        end.record()
        end.synchronize()
        round_ms.append(start.elapsed_time(end) / 3)
        losses += [x.item() for x in out]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"captured train losses not finite: {losses}")
    prof = profile_run(lambda: step(train_batch))
    line["train"] = {
        "B": TRAIN_B, "V": TRAIN_V, "ms_per_step": sorted(round_ms)[1],
        "ms_per_step_rounds": round_ms, "first_call_s": first_s,
        "launches_first_call": counts, "loss_per_step": losses,
        "device_ms": prof["device_ms"], "profile_wall_ms": prof["wall_ms"],
        "device_busy_share": prof["device_busy_share"],
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "graphs": len(step._captured.graphs)}
    del model, step, scalars, out
    fresh()
    line["train"]["vs_eager"] = checks.check_graph_train_step(make_model, train_batch, 3)
    del train_batch
    fresh()

    model = checks.seeded_model(checks.eval_dtu_config(), PIPELINE_SEED, dev)
    ds = SyntheticEvalDataset(V=PIPELINE_V, H=H, W=W)
    forward = make_eval_forward(model)
    want = {k: 2 * n for k, n in PIPELINE_LAUNCHES_PER_VIEW.items()}
    _, counts, first_s = counted(lambda: checks.run_pipeline(model, ds, dev, forward=forward),
                                 want, "pipeline")
    run = checks.run_pipeline(model, ds, dev, forward=forward)
    n_points = len(run["points"])
    if n_points != eager_pipeline["fused_points"]:
        raise AssertionError(f"captured pipeline: {n_points} fused points, eager "
                             f"{eager_pipeline['fused_points']}")
    line["pipeline"] = {
        "dtype": "float32", "first_run_s": first_s, "launches_first_run": counts,
        "ms_per_view_forward": float(np.median(run["forward_s"])) * 1e3,
        "ms_per_view_forward_all": [x * 1e3 for x in run["forward_s"]],
        "ms_per_view_filter": float(np.median(run["filter_s"])) * 1e3,
        "fused_points": n_points, "eager_fused_points": eager_pipeline["fused_points"],
        "eager_ms_per_view_forward": eager_pipeline["ms_per_view_forward"],
        "eager_ms_per_view_filter": eager_pipeline["ms_per_view_filter"],
        "graphs": len(forward.graphs)}
    del model, forward, run
    fresh()
    line["bench"] = {"captured_chain": drivers["bench"],
                     "ms_per_forward": drivers["bench_detail"]["ms_per_forward"],
                     "peak_memory_gb": drivers["bench_detail"]["peak_memory_gb"],
                     "peak_reserved_gb": drivers["bench_detail"]["peak_reserved_gb"]}
    return line, totals

def _per_run(rows):
    """Sums over the timed rows of each set, per run of the set's path
    (times the rows' launches per run): the kernel's time back to back from
    the host (``ms``) and its device time (``device_ms``), the plain
    version's, the bound and its parts, the library yardstick's from the
    host and on the device (None if a row has none)."""
    sums = {}
    for row_set in {r["set"] for r in rows}:
        timed = [r for r in rows if r["set"] == row_set and "kernel_ms" in r]
        if not timed:
            continue

        def total(key, timed=timed):
            return sum(r[key] * r["launches_per_run"] for r in timed)

        lib = not any(r["library_ms"] is None for r in timed)
        entry = {"ms": total("kernel_ms"), "device_ms": total("kernel_device_ms"),
                 "plain_ms": total("plain_ms"),
                 "bound_ms": total("bound_ms"), "bytes": total("bytes"), "ops": total("ops"),
                 "bound_by": "operations" if total("ops_ms") > total("bytes_ms") else "bytes",
                 "library_ms": total("library_ms") if lib else None,
                 "library_device_ms": total("library_device_ms") if lib else None}
        sums[row_set] = entry
    return sums


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to measure", file=sys.stderr)
        return 1
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.bench import card_name
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
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    counters = {"warp_cor": k1, "topdown": k2, "warp_bwd": k3, "warp_fwd": k4, "attn_fuse": k5,
                "band_conv": k6}
    EVAL_LAUNCHES["band_conv"] = VAL_LAUNCHES["band_conv"] = _k6_launches(torch.bfloat16)
    PIPELINE_LAUNCHES_PER_VIEW["band_conv"] = _k6_launches(torch.float32)
    kernels = _build.KERNELS
    # the eval CLI's device setup (TF32 off), so that every phase runs at
    # the precision a user of the port gets
    dev = setup_device()
    print(card_name())
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
    rows = check_kernels(dev, batch) + check_warp_cor_pipeline(dev) + check_topdown(dev) \
        + check_band_conv(dev) + check_attn_fuse_workspace(dev)
    k3_rows, bwd_library_diff = check_warp_bwd(dev, train_batch)
    k4_rows, fwd_library_diff = check_warp_fwd(dev, train_batch)
    rows += k3_rows + k4_rows
    # every kernel at FPN base 4 and 16: the generic instances; K1 and K4
    # on the full-range hypotheses
    for base, groups in OTHER_WIDTHS:
        rows += check_kernels(dev, batch, base, groups, f"eval_base{base}",
                              (("full_range", f"eval_base{base}"),))
        rows += check_warp_fwd(dev, train_batch, base, (("full_range", f"train_base{base}"),))[0]
        rows += check_warp_bwd(dev, train_batch, base, ("train",), f"_base{base}")[0]
    print(json.dumps({"kernel_shapes": rows,
                      "warp_bwd_library_max_abs_diff": bwd_library_diff,
                      "warp_fwd_library_max_abs_diff": fwd_library_diff}))

    model = checks.seeded_model(dtu_model_config(), SEED, dev)
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
        profile = profile_run(lambda: model(*args))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"profile": profile}))
    small = checks.check_forward(dev, seed=SEED + 1)
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

    print(json.dumps({"forward_other_widths": [
        checks.check_forward(dev, base, groups, seed=SEED + 1) for base, groups in OTHER_WIDTHS]}))
    print(json.dumps({"chain_backward": check_chain_backward(dev)}))
    torch.cuda.empty_cache()
    print(json.dumps({"small_train_step": checks.check_train_step(dev)}))
    base, groups = OTHER_WIDTHS[0]
    print(json.dumps({"small_train_step_other_width": {
        "base": base, "group_cor_dim": list(groups),
        **checks.check_train_step(dev, base=base, group_cor_dim=groups)}}))
    # the eager readings: drive_train, drive_pipeline and drive_variants run
    # the entry points as the port ran them before capture (graphs.eager);
    # drive_graphs holds the captured forms against them
    with graphs.eager():
        train, train_profile, train_counts = drive_train(dev, train_batch, counters)
    print(json.dumps({"train": train}))
    print(json.dumps({"train_profile": train_profile}))
    del train_batch
    torch.cuda.empty_cache()
    with graphs.eager():
        pipeline, pipeline_counts = drive_pipeline(dev, counters)
    print(json.dumps({"pipeline": pipeline}))
    torch.cuda.empty_cache()
    train_cli = drive_train_cli(counters)
    print(json.dumps({"train_cli": train_cli}))
    torch.cuda.empty_cache()
    batch = _scene(B, V, H, W, dev)
    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    t0 = time.perf_counter()
    with graphs.eager():
        variant_counts = drive_variants(dev, batch, train_batch, counters)
    print(json.dumps({"variants": {"count": len(checks.VARIANTS),
                                   "wall_s": time.perf_counter() - t0,
                                   "launches": variant_counts}}))
    del batch, train_batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    space, space_counts = drive_space(dev, counters, space_rows := [])
    space["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"space_kernel_shapes": space_rows}))
    print(json.dumps({"space": space}))
    rows += space_rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    ddp, ddp_counts = drive_ddp(dev, train_batch, counters)
    ddp["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"ddp": ddp}))
    del train_batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    debug, debug_counts = drive_debug(dev, counters)
    debug["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"debug": debug}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    drivers, drivers_counts = drive_drivers(dev, counters)
    drivers["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"drivers": drivers}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graphs_line, graphs_counts = drive_graphs(dev, counters, pipeline, drivers)
    graphs_line["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"graphs": graphs_line}))

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
            "launches": (counts[name] + train_counts[name] + pipeline_counts[name]
                         + variant_counts[name] + space_counts[name] + ddp_counts[name]
                         + debug_counts[name] + drivers_counts[name] + graphs_counts[name]),
            "launches_eval": counts[name], "launches_train": train_counts[name],
            "launches_pipeline": pipeline_counts[name],
            "launches_variants": variant_counts[name],
            "launches_space": space_counts[name], "launches_ddp": ddp_counts[name],
            "launches_debug": debug_counts[name], "launches_drivers": drivers_counts[name],
            # the graphs phase's counted first calls: each captures, and its
            # eager warm-up and its capture launch every kernel once
            "launches_graphs": graphs_counts[name],
            "launches_train_cli": sum(c[name] for c in train_cli["launches"].values()),
            "timed_per": "eval forward" if row_set == "eval" else "train step",
            "max_abs_err": max(r["max_abs_diff"] for r in mine if r["dtype"] == "bfloat16"),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            # the device time of the same launches and library calls (20 of
            # each captured in one CUDA graph): ``ms`` includes the host's
            # time per call where that is longer than the launch
            "device_ms": main["device_ms"], "library_device_ms": main["library_device_ms"],
        }
        if name == "band_conv":
            # the route it replaces, and the least time of its sums on the
            # float32 CUDA cores, where this kernel computes them
            entry["unfused_ms"] = sum(r["unfused_ms"] * r["launches_per_run"]
                                      for r in mine if r["set"] == row_set)
            entry["cuda_core_bound_ms"] = main["ops"] / FP32_FLOPS * 1e3
        if name == "topdown":
            # the train step (forward and the backward's u_only, bf16) and
            # one view of the float32 pipeline
            entry["train_step"] = sums["train"]
            entry["pipeline_float32_view"] = sums["pipeline_float32"]
        if name in ("warp_bwd", "warp_fwd"):
            # the full inverse range at every stage
            entry["full_range"] = sums["full_range"]
        if name == "warp_cor":
            # the full inverse range at every stage, and one
            # view of the float32 pipeline (B1) on its own hypotheses
            entry["full_range"] = sums["eval_full_range"]
            entry["pipeline_float32_view"] = sums["pipeline_float32"]
        if name == "band_conv":
            # the float32 rows: the pipeline's route at B4, and one view of
            # the pipeline (B1)
            entry["float32_forward"] = sums["eval_float32"]
            entry["pipeline_float32_view"] = sums["pipeline_float32"]
            # ASFF's expand convs (the asff variant's forward; float32: the
            # layers its route takes)
            entry["asff_expand"] = sums["asff_eval"]
            entry["asff_expand_float32"] = sums["asff_eval_float32"]
        if name == "attn_fuse":
            # one view of the float32 pipeline (B1), and the workspace
            # kernel's rows (per call of each K5_WORKSPACE shape)
            entry["pipeline_float32_view"] = sums["pipeline_float32"]
            entry["workspace"] = sums["workspace"]
        # the same path at FPN base 4 and 16, through the generic instances
        entry["other_widths"] = {k: v for k, v in sums.items() if "_base" in k}
        if name in ("warp_cor", "attn_fuse", "band_conv"):
            # the row windows of the space phase, per sharded forward
            entry["space_windows"] = {k: v for k, v in sums.items() if k.startswith("space_")}
        kernel_line.append(entry)
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
