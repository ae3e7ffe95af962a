#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the port's ten CUDA kernels from ``csrc/`` (one ``nvcc`` per
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
   weights and the unfused route it replaces (the library's conv, then
   BatchNorm + ReLU as one ``norm_act`` pass), at every 3x3
   stride-1 layer of the stem and Reg2D.conv0, timed in both dtypes, the
   rows that back its route rule in ``models/layers.py``, and in float32 at
   one B1 pipeline view) and ``norm_act`` (eval BatchNorm + ReLU after a
   library convolution, at every shape of its calls in the eval forward in
   both dtypes and at one B1 pipeline view, beside its plain version, the
   chain of PyTorch kernels it replaced, and PyTorch's eval
   ``F.batch_norm`` + ``relu_``) at the eval forward's shapes;
   ``deform_conv`` (a DCN head's taps and contraction) at each head of the
   flagship with DCN heads (B4 V4 512x640 bf16, C 64 to 8) at offsets of
   0.1 and 4 px std, beside its plain version; ``convnext_block`` (a
   patchify ConvNeXt block) at each block of the ``fpn_convnext4`` model's
   eval forward (B4 V4 512x640 bf16, dim 8, 16, 32), beside its plain
   version; ``bn_train`` (train-mode
   BatchNorm + ReLU, forward and backward) at every shape of its calls in
   the B6 V5 train step, beside its plain version, the float32 chain and
   its autograd backward; K2 (FPN top-down level) at the eval
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
   and BatchNorm statistics on plane-scene inputs: the launches of one
   forward are counted (K1 12 launches,
   K2 3, K5 4, K6 12: every 3x3 stride-1 layer on its bf16 route;
   ``norm_act`` 39: every other eval BatchNorm, ``checks.
   norm_act_modules``), then three rounds of five forwards are timed.
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
   Adam lr 1e-3 wd 1e-4) on plane scenes: the launches of one step are
   counted (K4 16, K3 16, K2 6, K6 0, ``norm_act`` 0, ``bn_train`` 324:
   six launches at each of the 54 train-mode BatchNorms), then a
   warm-up step and three rounds of three timed steps, and a profile of one
   step.
8. Drives the eval pipeline of the eval CLI at full width
   (``checks.run_pipeline``: the scripts/eval_dtu.sh model in float32, B=1,
   a 4-view 512x640 plane scene with 192 hypotheses): the depth maps of
   every reference view, each view filtered against its 3 sources, the
   fused PLY written to ``PIPELINE_PLY``; the launches of the run are
   counted (per view K1 12, K2 3, K5 4, K6 10:
   its float32 route stops at 32 channels; ``norm_act`` 41;
   ``deform_conv`` 0),
   and a profile of one more run. Then the same pipeline at 64x128 on the
   card against the CPU (``checks.check_pipeline``). K6's launches per
   forward follow its route rule (``_k6_launches``).
9. Drives the train CLI (``cli.train.main`` in this process) at full width
   with scripts/train_dtu.sh's model, loss and optimizer flags on 12
   synthetic 512x640 scenes of 5 views, B=6, logdir ``chiprun_out/
   train_cli``: one epoch (2 steps, 2 validation batches, ``model_00.ckpt``),
   ``--resume --epochs 2`` (continues at epoch 2, step 2), ``--mode test``
   and ``--mode profile`` (a Chrome trace); the launches of each part are
   counted. The CLI's steps are captured graphs: each
   part's first train step and first validation batch launch every kernel
   twice (the warm-up's and the capture's launches), the later ones replay
   (per captured train step K4 16, K3 16, K2 6, K6 0, ``bn_train`` 324; per
   validation batch
   K1 16, K2 3, K5 4, K6 12, ``norm_act`` 39).
10. Drives every model variant (``checks.VARIANTS``: the flagship with one
   change, pos-enc sine and learned, reg3d, the CAM/DCAM/PAM/PDAM mid
   blocks, GroupNorm, ASFF, the two ConvNeXt pyramids, DCN heads with
   BatchNorm and with GroupNorm; ``drive_variants``): per variant, the
   launches of one B4 V4 512x640 bf16 eval forward counted and held to its
   own (K1 12, K2 3, K5 4, K6 from the route rule over its layers,
   ``_k6_launches``; ``norm_act`` its ``checks.norm_act_modules``;
   ``deform_conv`` 4 with DCN heads, ``convnext_block`` 3 with the
   patchify ConvNeXt pyramid, else 0), three rounds of five
   timed forwards and one profiled; the same around one DTU train step
   (K4 16, K3 16, K2 6, K6, ``norm_act`` and ``deform_conv`` 0, ``bn_train``
   six at each of its train-mode BatchNorms, ``_bn_train_launches``) and
   three timed steps; then the small
   float32 forward and train step against the CPU. K6's rows also hold
   ASFF's ``expand`` convs (sets ``asff_eval``, ``asff_eval_float32``).
11. The row-sharded ``--space`` eval (``drive_space``), on this one card
   (``parallel.mesh.sharded_eval_forward`` over ``[cuda:0] * S``: the
   decomposition, not multi-card speed): the B4 V4 512x640 flagship in
   float32 and bf16 at S 2 and 4, and a Tanks&Temples-sized B1 V5
   1024x1920 bf16 view at S 4, halo 48; each eager and captured (one CUDA
   graph per rank per round, replayed) beside each other: the launches of
   one sharded forward counted (eager S times the unsharded forward's;
   the captured form's first call 2S times, a replay none), every stage
   held to the unsharded forward (``checks.compare_space``), timed,
   profiled, peak memory; the replay
   held to the eager form (``checks.check_graph_space``); K1, K5 and K6 at
   every window shape against their plain versions (sets
   ``space_<run>_S<S>_<dtype>``).
12. Data-parallel training (``drive_ddp``): an NCCL group of one rank, the
   DTU recipe through ``parallel.mesh.data_parallel`` for each ``dp_impl``
   against the bare step from the same seed, eager
   (``checks.check_ddp_step``) and captured (``checks.check_graph_ddp_step``:
   against eager runs of its form, ``gspmd`` with a one-rank group, and
   against the bare step; the one-rank group's steps take the plain
   BatchNorm, whose statistics it all-reduces, and launch no ``bn_train``);
   each form eager and captured beside each other
   (ms a step, busy share, peak memory, the NCCL kernels of one profiled
   step); the launches of each part counted; then ``torchrun --standalone
   --nproc_per_node 1`` running the train CLI for one epoch, its steps
   captured.
13. The debug dumps (``drive_debug``): the eval CLI with ``--debug_model
   255`` on a 4-view 512x640 scene, on the card (counted: the captured
   forward's warm-up and capture, the dump's eager forward, ``norm_act``
   at each BatchNorm that bit 0 recomputes, and K4 for bits 5 and 6) and
   with ``--device cpu``, the dumps compared
   (``checks.compare_debug_dumps``).
14. The port's drivers (``drive_drivers``), each as a user runs it: the
   eval bench (``python -m <port>.bench`` at its pinned B4 V4 512x640,
   CHAIN 5, ROUNDS 10, GROUPS 3, its chain a captured graph; its last
   line printed back), the first call of ``graft_entry.entry()``'s ``fn``
   at the bench shape, which captures (counted: twice K1 12, K2 3, K5 4,
   K6 12), and a replay that counts none, ``scripts/bench_scaling.py``
   at one rank (its set-up split and row; its data-parallel step
   captured, the timed steps replays), the dry run ``graft_entry 1`` (its
   data-parallel steps captured) and ``tools/train_demo.py`` for its 300
   steps.
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
readings that phase 15 holds the captured forms against; phases 11 and
12 read their mesh paths both ways. Every phase counts the launches of
all ten kernels (``ops/_build.KERNELS``) the same way (``_counted``:
``_build.launch_counts()`` before and after) and holds them to the same
tables (``EVAL_LAUNCHES``, ``TRAIN_LAUNCHES``, ``PIPELINE_LAUNCHES_PER_VIEW``,
``VAL_LAUNCHES``): a captured function's first call with a new input
signature launches every kernel twice (its eager warm-up and its capture),
and a replay launches none; the ``kernels`` line's ``launches_graphs`` are
phase 15's counted first calls.

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
# launches of each kernel of ops/_build.KERNELS on each path: an eval
# forward (B4 V4), a train step (B6 V5), one reference view of the eval
# pipeline (V4) and one validation batch of the train CLI (B6 V5). K6's
# follow its route rule (models/layers.band_conv_route, _k6_launches),
# norm_act's the eval BatchNorms off that route (checks.norm_act_modules,
# _norm_act_launches) and bn_train's the train-mode BatchNorms
# (_bn_train_launches): main() fills them in. No flagship path has DCN heads
# or ConvNeXt blocks.
EVAL_LAUNCHES = {"warp_cor": 12, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0, "attn_fuse": 4,
                 "band_conv": None, "norm_act": None, "deform_conv": 0, "bn_train": 0,
                 "convnext_block": 0}
TRAIN_LAUNCHES = {"warp_cor": 0, "topdown": 6, "warp_bwd": 16, "warp_fwd": 16, "attn_fuse": 0,
                  "band_conv": 0, "norm_act": 0, "deform_conv": 0, "bn_train": None,
                  "convnext_block": 0}
PIPELINE_LAUNCHES_PER_VIEW = {"warp_cor": 12, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0,
                              "attn_fuse": 4, "band_conv": None, "norm_act": None,
                              "deform_conv": 0, "bn_train": 0, "convnext_block": 0}
VAL_LAUNCHES = {"warp_cor": 16, "topdown": 3, "warp_bwd": 0, "warp_fwd": 0, "attn_fuse": 4,
                "band_conv": None, "norm_act": None, "deform_conv": 0, "bn_train": 0,
                "convnext_block": 0}
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


def _norm_act_launches(cfg) -> int:
    """``norm_act``'s launches per eval forward of a model of ``cfg`` in its
    dtype: its eval BatchNorms off K6's route (``checks.norm_act_modules``)."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    return checks.norm_act_modules(MVS4Net(cfg, device="cpu"), cfg.torch_dtype)


def _bn_train_launches(cfg) -> int:
    """``bn_train``'s launches per train step (forward and backward) of a
    model of ``cfg``: ``bn_train.LAUNCHES_PER_CALL`` at each train-mode
    BatchNorm (``checks.bn_train_modules``), each called once a step."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import bn_train

    model = MVS4Net(cfg, device="cpu").train()
    return bn_train.LAUNCHES_PER_CALL * checks.bn_train_modules(model)


def _counted(fn):
    """``fn()`` and ``{kernel: launches}`` of the launches it made, for every
    kernel of ``ops/_build.KERNELS``: the difference of ``_build.
    launch_counts()`` after and before, the device synchronised around."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build

    torch.cuda.synchronize()
    before = _build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    return out, {name: after[name] - before[name] for name in after}


def _add(totals, counts):
    """Add ``counts`` to ``totals`` (both ``{kernel: launches}``)."""
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n


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
    ``relu_``) and the unfused route K6 replaces (cuDNN conv, then
    ``TorchBatchNorm`` in eval with its ReLU: one ``norm_act`` pass). The bound counts x read and
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
                return bn(conv2d_nhwc(x, wt, padding=1), relu=True)

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


# norm_act's row sets: (set, dtype, batch): the eval forward at B4 in both
# dtypes, and one view of the float32 pipeline (B1, the same model and
# hypotheses at every stage)
NORM_ACT_SETS = (("eval", "bfloat16", B), ("eval_float32", "float32", B),
                 ("pipeline_float32", "float32", 1))


def _head(batch, n):
    """The first ``n`` samples of a batch of tensors (nested dicts)."""
    return {k: _head(v, n) if isinstance(v, dict) else v[:n] for k, v in batch.items()}


def _norm_act_calls(dev, batch, dtype_name):
    """``{(shape, relu): calls}`` of ``norm_act`` in one eager eval forward
    of the flagship (``dtu_model_config``, seeded) in ``dtype_name`` on
    ``batch``, and ``checks.norm_act_modules`` of that model."""
    from collections import Counter
    from unittest import mock

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        norm_act as na,
    )

    model = checks.seeded_model(dtu_model_config(dtype_name), SEED, dev)
    calls, real = Counter(), na.norm_act

    def record(x, *rest):
        calls[(tuple(x.shape), rest[-1])] += 1
        return real(x, *rest)

    with mock.patch.object(na, "norm_act", record), torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    return calls, checks.norm_act_modules(model, getattr(torch, dtype_name))


def check_norm_act(dev, batch):
    """``norm_act`` against ``norm_act_ref`` at every shape of its calls in
    each of ``NORM_ACT_SETS`` (the shapes read from a forward), with random
    BatchNorm statistics and affine parameters, timed beside the plain
    version (the chain of PyTorch elementwise kernels the eval BatchNorm and
    its ReLU were before the kernel) and the library yardstick (PyTorch's
    own eval ``F.batch_norm`` on the channels-last view, then an in-place
    ``relu_``: two passes). A row's ``max_abs_diff`` is the largest
    ``|kernel - plain|`` over ``norm_act.limit`` at its element (at most 1),
    ``max_abs_gap`` the largest difference itself, ``library_share_of_limit``
    the library's largest ``|library - plain|`` over the same limit. The
    bound counts x read and the output written once (and the four ``[C]``
    tensors); 3 operations an element (multiply, add, max) on the CUDA
    cores."""
    import torch
    import torch.nn.functional as F

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        norm_act as na,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = []
    for row_set, dtype_name, b in NORM_ACT_SETS:
        dtype = getattr(torch, dtype_name)
        calls, modules = _norm_act_calls(dev, _head(batch, b), dtype_name)
        if sum(calls.values()) != modules:
            raise AssertionError(f"norm_act {row_set}: {sum(calls.values())} calls, "
                                 f"{modules} library-route eval BatchNorms")
        for (shape, relu), n in sorted(calls.items()):
            C = shape[-1]
            x = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
            bn = (torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5,
                  torch.randn(C, generator=gen, device=dev) * 0.2,
                  torch.randn(C, generator=gen, device=dev) * 0.2,
                  torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5)
            args = (x, *bn, 1e-5, relu)
            got, want = na.norm_act(*args), na.norm_act_ref(*args)

            def run_library(x=x, bn=bn, relu=relu):
                w, b, mean, var = bn
                y = F.batch_norm(x.movedim(-1, 1), mean, var, w, b, False, 0.0, 1e-5)
                return (y.relu_() if relu else y).movedim(1, -1)

            lib = run_library()
            torch.cuda.synchronize()
            gap = (got.float() - want.float()).abs()
            share = (gap / na.limit(got, want, *args[:-1])).max().item()
            lib_share = ((lib.float() - want.float()).abs()
                         / na.limit(lib, want, *args[:-1])).max().item()
            nbytes = 2 * x.numel() * x.element_size() + 4 * 4 * C
            _record(rows, "norm_act", "pipeline" if row_set.startswith("pipeline") else "eval",
                    list(shape), dtype, share, 1.0, n, lambda a=args: na.norm_act(*a),
                    lambda a=args: na.norm_act_ref(*a), nbytes, 3 * x.numel(), FP32_FLOPS,
                    run_library=run_library, row_set=row_set, timed=True, relu=relu,
                    max_abs_gap=gap.max().item(), library_share_of_limit=lib_share)
    return rows


def _bn_train_calls(dev, batch):
    """``{(shape, groups, relu): calls}`` of ``bn_train`` in one train-mode
    forward of the flagship (``dtu_model_config``, seeded) on ``batch``,
    and ``checks.bn_train_modules`` of that model."""
    from collections import Counter
    from unittest import mock

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        bn_train as bt,
    )

    model = checks.seeded_model(dtu_model_config(), SEED, dev).train()
    calls, real = Counter(), bt.bn_train

    def record(x, *rest):
        calls[(tuple(x.shape), rest[5], rest[-1])] += 1
        return real(x, *rest)

    with mock.patch.object(bt, "bn_train", record), torch.no_grad():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    return calls, checks.bn_train_modules(model)


def check_bn_train(dev, batch):
    """``bn_train`` against ``bn_train_ref`` at every shape of its calls in
    the flagship's B6 V5 512x640 bf16 train step (the shapes read from a
    train-mode forward on ``batch``; 54 calls), forward and backward, with
    random BatchNorm parameters and statistics: a row's ``max_abs_diff`` is
    the largest share of its limit over y, the running statistics, dx,
    dweight and dbias (``checks.check_bn_train``, at most 1; ``shares``
    each). Timed: the kernels' six launches (the forward and
    ``torch.autograd.grad`` through ``BNTrain``) beside the plain version
    (the float32 chain and autograd's backward of it). The bound counts 16
    bytes a bf16 element (x read twice and y written; x and dy read twice
    and dx written) and 24 float32 operations an element on the CUDA
    cores."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        bn_train as bt,
    )

    calls, modules = _bn_train_calls(dev, batch)
    if sum(calls.values()) != modules:
        raise AssertionError(f"bn_train: {sum(calls.values())} calls, {modules} train-mode "
                             "BatchNorms")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rows = []
    for (shape, groups, relu), n in sorted(calls.items()):
        C = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5
        b = torch.randn(C, generator=gen, device=dev) * 0.2
        rm = torch.randn(C, generator=gen, device=dev) * 0.2
        rv = torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5
        shares = checks.check_bn_train(x, dy, w, b, rm, rv, groups, relu)
        xk = x.clone().requires_grad_(True)
        wk, bk = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        nbk = torch.zeros((), dtype=torch.long, device=dev)

        def timed(fn, xk=xk, wk=wk, bk=bk, rm=rm.clone(), rv=rv.clone(), nbk=nbk, dy=dy,
                  groups=groups, relu=relu):
            def run():
                y = fn(xk, wk, bk, rm, rv, nbk, groups, 1e-5, 0.9, relu)
                return torch.autograd.grad(y, (xk, wk, bk), dy)
            return run

        _record(rows, "bn_train", "train", list(shape), torch.bfloat16, shares["max_share"], 1.0,
                n, timed(bt.bn_train), timed(bt.bn_train_ref), 16 * x.numel() + 4 * 8 * C,
                24 * x.numel(), FP32_FLOPS, timed=True, groups=groups, relu=relu,
                shares=shares)
    return rows


# deform_conv's row sets: (set, std of the offsets in px): the offsets of
# make_weights' heads (0.07-0.15 px std) and of a trained head (pixels)
DEFORM_CONV_SETS = (("eval", 0.1), ("eval_offsets_4px", 4.0))


def _deform_conv_calls(dev, batch):
    """The shape of ``x`` at each ``deform_conv`` call in one eager eval
    forward of the flagship with DCN heads (``dcn``, bf16, seeded) on
    ``batch``, in order (the shapes to time; the launches a forward are
    counted in ``drive_variants``)."""
    import dataclasses
    from unittest import mock

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        deform_conv as dc,
    )

    cfg = dataclasses.replace(dtu_model_config(), dcn=True)
    model = checks.seeded_model(cfg, SEED, dev)
    calls, real = [], dc.deform_conv

    def record(x, off, weight):
        calls.append(tuple(x.shape))
        return real(x, off, weight)

    with mock.patch.object(dc, "deform_conv", record), torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    return calls


def check_deform_conv(dev, batch):
    """``deform_conv`` at each head of the DCN model's eval forward (the
    shapes read from a forward: B4 V4 512x640 bf16, C 64, 32, 16, 8), on
    random inputs and offsets of each of ``DEFORM_CONV_SETS``' spreads,
    against its plain version in float32 with the same bf16 weight (a
    row's ``max_abs_diff`` is ``deform_conv.limit_share``, at most 1), timed
    beside the plain
    version in bf16 (the route it replaced: per tap four gathers, the taps'
    concatenation and one matmul). The bound is ``benchmark/counts/dcn.py``'s
    for a head less its offset conv: x read and the output written once
    and the 9C x C weight, in bf16; the taps' 9 P (10 + 7 C) operations on
    the float32 CUDA cores and the contraction's 2 P 9 C C on the bf16
    tensor cores (``ops`` counts the latter at the CUDA cores' rate, so that
    ops / peak is the sum of the two times). ``offset_bytes`` is the
    offsets the kernel reads besides, which the count leaves inside the
    head."""
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        deform_conv as dc,
    )

    calls = _deform_conv_calls(dev, batch)
    if [c[-1] for c in calls] != [64, 32, 16, 8]:
        raise AssertionError(f"deform_conv: calls {calls}, want one a head at C 64, 32, 16, 8")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rows = []
    for row_set, spread in DEFORM_CONV_SETS:
        for shape in calls:
            N, h, w, C = shape
            x = torch.randn(shape, generator=gen, device=dev).relu_().to(torch.bfloat16)
            off = (torch.randn((N, h, w, 18), generator=gen, device=dev) * spread).to(x.dtype)
            wt = torch.randn((C, C, 3, 3), generator=gen, device=dev) * (9 * C) ** -0.5
            share = dc.limit_share(dc.deform_conv(x, off, wt), x, off, wt)
            P = N * h * w
            nbytes = 2 * (2 * P * C + 9 * C * C)
            ops = 9 * P * (10 + 7 * C) + 2 * P * 9 * C * C * FP32_FLOPS / BF16_TENSOR_FLOPS
            _record(rows, "deform_conv", "eval", list(shape), x.dtype, share, 1.0, 1,
                    lambda a=(x, off, wt): dc.deform_conv(*a),
                    lambda a=(x, off, wt): dc.deform_conv_ref(*a), nbytes, ops, FP32_FLOPS,
                    row_set=row_set, timed=True, offset_std_px=spread,
                    offset_bytes=2 * P * 18)
            torch.cuda.empty_cache()
    return rows


def _convnext_block_calls(dev, batch):
    """The shape of ``x`` at each ``convnext_block`` call in one eager eval
    forward of the flagship with the patchify ConvNeXt pyramid
    (``fpn_convnext4``, bf16, seeded) on ``batch``, in order (the shapes to
    time; the launches a forward are counted in ``drive_variants``)."""
    import dataclasses
    from unittest import mock

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        convnext_block as cb,
    )

    cfg = dataclasses.replace(dtu_model_config(), arch_mode="fpn_convnext4")
    model = checks.seeded_model(cfg, SEED, dev)
    calls, real = [], cb.convnext_block

    def record(x, *params, eps):
        calls.append(tuple(x.shape))
        return real(x, *params, eps=eps)

    with mock.patch.object(cb, "convnext_block", record), torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    return calls


def check_convnext_block(dev, batch):
    """``convnext_block`` at each block of the ``fpn_convnext4`` model's
    eval forward (the shapes read from a forward: B4 V4 512x640 bf16, dim
    8, 16, 32), on a random input and parameters drawn as the benchmark
    draws them (``gamma`` and the LayerNorm weight N(0, 1)), against its
    plain version in float32 with the weights rounded as the plain route
    rounds them (a row's ``max_abs_diff`` is ``convnext_block.limit_share``,
    at most 1), timed beside the plain version in bf16 (the route it
    replaced). The bound is ``benchmark/counts/convnext.py``'s for the
    block: its convolutions at the bf16 tensor cores' rate (``ops`` counts
    them at the CUDA cores', so that ops / peak is the sum of the two
    times), the LayerNorm, GELU and scale on the CUDA cores, and its bytes
    (the first block's input read, each output written and read by the
    next, the weights)."""
    import torch

    from benchmark.counts import convnext as convnext_counts
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
        convnext_block as cb,
    )

    calls = _convnext_block_calls(dev, batch)
    pieces = convnext_counts.blocks(B, V, H, W, dtu_model_config().fpn_base_channel, "bfloat16")
    if [c[-1] for c in calls] != [8, 16, 32]:
        raise AssertionError(f"convnext_block: calls {calls}, want one a block at dim 8, 16, 32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows = []
    for shape, piece in zip(calls, pieces):
        dim = shape[-1]
        c2, c4 = 2 * dim, 4 * dim
        x = draw(*shape).relu_().to(torch.bfloat16)
        params = (draw(c2, dim, 2, 2, scale=(4 * dim) ** -0.5), draw(c2, scale=0.05),
                  draw(c2, 2, 7, 7, scale=98 ** -0.5), draw(c2, scale=0.05), draw(c2),
                  draw(c2, scale=0.05), draw(c4, c2, scale=c2 ** -0.5), draw(c4, scale=0.05),
                  draw(c2, c4, scale=c4 ** -0.5), draw(c2, scale=0.05), draw(c2))
        share = cb.limit_share(cb.convnext_block(x, *params), x, params)
        torch.cuda.empty_cache()
        ops = piece["conv_flops"] * FP32_FLOPS / BF16_TENSOR_FLOPS + piece["other_flops"]
        _record(rows, "convnext_block", "eval", list(shape), x.dtype, share, 1.0, 1,
                lambda a=(x, *params): cb.convnext_block(*a),
                lambda a=(x, *params): cb.convnext_block_ref(*a), piece["bytes"], ops,
                FP32_FLOPS, timed=True)
        torch.cuda.empty_cache()
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
    the total, the device's busy share of the call (the union of its device
    intervals over the call's range on the profiler's clock, as
    ``benchmark/harness.py`` reads a stretch: at most 1 where streams
    overlap), the share of each of the port's kernels and of the
    convolution library (cuDNN's and CUTLASS's convolutions and GEMMs:
    ``share_conv_library``), sorted by ``tools/trace_table.py:category``,
    the count of NCCL kernels, and the ten largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools import trace_table

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.profile_run"):
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
    events = prof.events()
    run = next(e.time_range for e in events if e.name == "chip_smoke.profile_run"
               and e.device_type == torch.autograd.DeviceType.CPU)
    merged = []
    for a, b in sorted((max(e.time_range.start, run.start), min(e.time_range.end, run.end))
                       for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.name.startswith(("chip_smoke.", "mvster."))):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    busy_ms = sum(b - a for a, b in merged) / 1e3

    def share(*labels):
        return sum(cats[c] for c in labels) / total if total else 0.0

    return {
        "device_ms": total, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms * 1e3 / (run.end - run.start) if run.end > run.start else 0.0,
        "nccl_kernels": sum(n for k, _, n in kernels if "nccl" in k.lower()),
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

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        leaves, grads = checks.chain_inputs(TRAIN_B * TRAIN_V, H >> 3, W >> 3, dtype, dev, gen)
        entry = checks.check_chain_backward(leaves, grads)
        if dtype == torch.bfloat16:
            entry["function_fwd_bwd_ms"], counts = _counted(
                lambda: _time_ms(lambda: checks.chain_function_grads(leaves, grads), 3))
            entry["k2_launches_per_fwd_bwd"] = counts["topdown"] // 4
            entry["plain_fwd_bwd_ms"] = _time_ms(
                lambda: checks.chain_plain_grads(leaves, grads), 3)
        out[str(dtype).replace("torch.", "")] = entry
    return out


def drive_train(dev, batch):
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
    loss, counts = _counted(lambda: step(batch)["loss"].item())     # the main path, counted
    if counts != TRAIN_LAUNCHES:
        raise AssertionError(f"launches per train step {counts}, want {TRAIN_LAUNCHES}")
    losses = [loss]
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
        "loss_per_step": losses, "launches_per_step": counts,
        "norm_act_launches_per_step": counts["norm_act"],
        "timed_steps": reps * rounds,
        "peak_memory_gb": peak_gb,
    }
    return train, prof, counts


def drive_pipeline(dev):
    """The eval CLI's path at full width (``checks.run_pipeline``): the
    scripts/eval_dtu.sh model in float32 (weights and BatchNorm statistics
    from ``PIPELINE_SEED``), B=1, a SyntheticEvalDataset of 4 views at
    512x640 with 192 hypotheses; depth maps of every reference view, each
    filtered against its 3 sources (photomask 0.3, geomask 2, condmask 1.0 /
    0.01), the fused PLY written to ``PIPELINE_PLY``. One warm-up run, then the counted run.
    Then the same pipeline at 64x128 on the card against the CPU."""
    import numpy as np

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        SyntheticEvalDataset,
    )

    model = checks.seeded_model(checks.eval_dtu_config(), PIPELINE_SEED, dev)
    ds = SyntheticEvalDataset(V=PIPELINE_V, H=H, W=W)
    checks.run_pipeline(model, ds, dev)              # warm-up
    os.makedirs(os.path.dirname(PIPELINE_PLY), exist_ok=True)
    run, counts = _counted(lambda: checks.run_pipeline(model, ds, dev, ply_path=PIPELINE_PLY))
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
        "launches_per_view": per_view, "norm_act_launches_per_view": per_view["norm_act"],
        "deform_conv_launches_per_view": per_view["deform_conv"],
        "fused_points": n_points,
        "points_per_view": run["point_counts"],
        "final_mask_share": float(np.mean([m.mean() for m in run["final_masks"].values()])),
        "ply": PIPELINE_PLY, "ply_bytes": os.path.getsize(PIPELINE_PLY),
        "small_vs_cpu_float32": checks.check_pipeline(dev),
    }, counts


def drive_variants(dev, batch, train_batch):
    """Every model variant of ``checks.VARIANTS`` (the flagship with one
    change) on the card, one JSON line each:

    1. the eval forward at B4 V4 512x640 bf16 (weights and BatchNorm
       statistics from ``checks.seeded_model``): the launches of one
       forward counted, held to the variant's (K1 12, K2 3, K5 4, K6 by
       ``_k6_launches``, ``norm_act`` by ``checks.norm_act_modules``,
       ``deform_conv`` 4 with DCN heads, else 0, ``convnext_block`` 3 with
       the patchify ConvNeXt pyramid, else 0); finite depth of
       the expected shape; three rounds of five timed forwards, the peak
       memory, and the device time of one forward by ``profile_run``;
    2. the DTU train step (B6 V5 512x640 bf16, recipe loss, Adam): the
       launches of one step, held to ``TRAIN_LAUNCHES`` (``bn_train`` by
       ``_bn_train_launches``); a finite,
       present gradient on every parameter; a warm-up step and three timed
       steps, the peak memory;
    3. the small float32 checks against the CPU: ``checks.check_forward``
       and ``checks.check_train_step`` with the variant.

    Returns the launches of each kernel summed over the counted forwards
    and steps, and each variant's counts (``{name: {"eval": ...,
    "train": ...}}``)."""
    import dataclasses

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )

    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    totals, per_variant = {}, {}

    def counted(fn):
        out, counts = _counted(fn)
        _add(totals, counts)
        return out, counts

    for name, variant in checks.VARIANTS:
        cfg = dataclasses.replace(dtu_model_config(), **variant)
        model = checks.seeded_model(cfg, SEED, dev)
        want = {**EVAL_LAUNCHES, "band_conv": _k6_launches(torch.bfloat16, variant),
                "norm_act": checks.norm_act_modules(model, torch.bfloat16),
                "deform_conv": 4 if variant.get("dcn") else 0,
                "convnext_block": 3 if variant.get("arch_mode") == "fpn_convnext4" else 0}
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
        want_train = {**TRAIN_LAUNCHES, "bn_train": _bn_train_launches(cfg)}
        scalars, train_counts = counted(lambda: step(train_batch))   # the variant's path
        if train_counts != want_train:
            raise AssertionError(f"{name}: launches per train step {train_counts}, "
                                 f"want {want_train}")
        per_variant[name] = {"eval": counts, "train": train_counts}
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
    return totals, per_variant


def _read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def drive_train_cli():
    """The train CLI in this process at full width (``TRAIN_CLI_FLAGS``): one
    epoch (2 steps, 2 validation batches); ``--resume --epochs 2``, which
    must continue at epoch 2 and step 2; ``--mode test``; ``--mode
    profile``. The launches of each part are counted. Raises on a
    non-finite loss, a missing checkpoint or record, a learning rate off
    the schedule or a wrong count."""
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
        t0 = time.perf_counter()
        out, counts = _counted(lambda: cli.main(TRAIN_CLI_FLAGS + extra))
        seconds = time.perf_counter() - t0
        want = {name: 2 * (train_graphs * n + val_graphs * VAL_LAUNCHES[name])
                for name, n in TRAIN_LAUNCHES.items()}
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


def drive_space(dev, rows):
    """The row-sharded eval (``--space``) on one card: per run of
    ``SPACE_RUNS``, the unsharded forward counted and timed, then for each
    shard count S ``parallel.mesh.sharded_eval_forward`` over
    ``[card] * S`` (the windows' arithmetic, not multi-card speed), eager
    (``graphs.eager``) and captured (one CUDA graph per rank per round,
    replayed) beside each other: the launches of one forward counted
    (eager S times the unsharded forward's
    launches; the captured form's first call 2S times, its eager warm-up's
    and its capture's, and a replay none), every stage held to the
    unsharded forward (``checks.compare_space``), ms per forward from the
    host (the median of three) and between CUDA events (three back to
    back), the device time of one profiled forward (``profile_run``) and
    its busy share, peak memory allocated and reserved; the replay held to
    the eager form (``checks.check_graph_space``: bit-equal with
    deterministic cuDNN, and in bf16 without it); then K1, K5 and K6 at the
    window shapes against their plain versions (``_window_rows``, appended
    to ``rows``). Returns the phase's line and the launches of the counted
    forwards."""
    import contextlib
    import gc

    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.mvs4net import (
        _row_window,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
        sharded_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.trace_table import (
        PORT_KERNELS,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    totals, runs = {}, []

    def counted(fn):
        out, counts = _counted(fn)
        _add(totals, counts)
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
            forms = {}
            for mode in ("eager", "captured"):
                fwd = sharded_eval_forward(model, [dev] * S, space=S, space_halo=SPACE_HALO)
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    if mode == "eager":
                        fwd(*args)                                 # warm-up
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    got, counts = counted(lambda: fwd(*args))      # the space path
                    times = 1 if mode == "eager" else 2
                    expect = {k: times * S * n for k, n in whole_counts.items()}
                    if counts != expect:
                        raise AssertionError(f"space {name} S{S} {mode}: launches {counts}, "
                                             f"want {expect}")
                    agreement = checks.compare_space(got, want, dtype, depth_range,
                                                     what=f"space {name} {dtype_name} S{S} {mode}")
                    del got
                    _, replay_counts = counted(lambda: fwd(*args))
                    if mode == "captured" and any(replay_counts.values()):
                        raise AssertionError(f"space {name} S{S}: a replay launched "
                                             f"{replay_counts}")
                    host = []
                    for _ in range(3):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fwd(*args)
                        torch.cuda.synchronize()
                        host.append((time.perf_counter() - t0) * 1e3)
                    events_ms = _time_ms(lambda: fwd(*args), 3)
                    prof = profile_run(lambda: fwd(*args))
                    forms[mode] = {
                        "ms_per_forward_host": sorted(host)[1],
                        "ms_per_forward_host_all": host, "ms_per_forward_events": events_ms,
                        "device_ms": prof["device_ms"],
                        "device_busy_share": prof["device_busy_share"],
                        "kernel_shares": {k: prof[f"share_{k}"] for k in PORT_KERNELS},
                        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                        "launches_first_call": counts,
                        "graphs": sum(len(e.segments) for e in fwd.graphs.values()),
                        "vs_unsharded": agreement}
                del fwd
            vs_eager = checks.check_graph_space(model, [dev] * S, S, *args, SPACE_HALO)
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
                "unsharded_ms_per_forward": whole_ms, "unsharded_peak_memory_gb": whole_peak,
                "launches_per_rank": {k: n / S for k, n in
                                      forms["eager"]["launches_first_call"].items()},
                "window_copy_bytes_per_forward": copy_bytes, "row_set": row_set,
                "eager": forms["eager"], "captured": forms["captured"],
                "replay_vs_eager": vs_eager,
            })
        del model, batch, args, want
        torch.cuda.empty_cache()
    return {"devices": "one card, [cuda:0] * S", "runs": runs}, totals


DP_STEPS = 3
TORCHRUN_LOGDIR = TRAIN_CLI_LOGDIR + "_torchrun"


def _ddp_readings(dev, make_model, batch, dp_impl, captured):
    """The recipe step through ``data_parallel(step, dp_impl)`` as a world
    of one runs it, eager (``graphs.eager``) or captured: its first call
    (counted: eager ``TRAIN_LAUNCHES``, captured ``DDP_WARMUP_STEPS`` + 1
    times them, the eager warm-up steps' and the capture's), a second
    call, three rounds of three steps between CUDA events, one profiled
    step (device time, busy share, the NCCL kernels it shows), peak memory
    allocated and reserved."""
    import contextlib
    import gc

    import numpy as np
    import torch

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
        data_parallel,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import step as step_mod
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    model = make_model()
    step = data_parallel(step_mod.make_train_step(
        model, checks.RECIPE_LOSS, step_mod.make_optimizer(model, checks.DDP_WD),
        lambda i: checks.DDP_LR), dp_impl, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    def first():
        t0 = time.perf_counter()
        loss = step(batch)["loss"].item()
        return loss, time.perf_counter() - t0

    with contextlib.nullcontext() if captured else graphs.eager():
        (loss, first_s), counts = _counted(first)
        losses = [loss]
        times = step_mod.DDP_WARMUP_STEPS + 1 if captured else 1
        want = {k: times * n for k, n in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"ddp {dp_impl} captured={captured}: first call launched "
                                 f"{counts}, want {want}")
        losses.append(step(batch)["loss"].item())
        round_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = [step(batch)["loss"] for _ in range(3)]
            end.record()
            end.synchronize()
            round_ms.append(start.elapsed_time(end) / 3)
            losses += [x.item() for x in out]
        prof = profile_run(lambda: step(batch))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ddp {dp_impl} captured={captured}: losses {losses}")
    return {"ms_per_step": sorted(round_ms)[1], "ms_per_step_rounds": round_ms,
            "first_call_s": first_s, "launches_first_call": counts,
            "device_ms": prof["device_ms"], "device_busy_share": prof["device_busy_share"],
            "nccl_kernels_one_step": prof["nccl_kernels"],
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
            "graphs": len(step._captured.graphs), "losses": losses}


def drive_ddp(dev, batch):
    """Data-parallel training on one card: a world of one rank over NCCL
    (a ``file://`` store in a temporary directory), the DTU recipe (B6 V5
    512x640 bf16), the launches of each part counted:

    1. ``checks.check_ddp_step``: ``DP_STEPS`` eager steps of each
       ``dp_impl`` against ``checks.DDP_BARE_RUNS`` runs of the bare
       ``TrainStep`` from the same seed, whose gaps from each other are the
       step's run-to-run noise (every step ``TRAIN_LAUNCHES``);
    2. ``checks.check_graph_ddp_step``: each ``dp_impl`` captured, held to
       eager runs of its form (``gspmd`` with a one-rank group, so that its
       BatchNorm and loss all-reduces are in the graph) and to the bare
       step, with deterministic cuDNN; a captured run's first call
       launches every kernel ``DDP_WARMUP_STEPS`` + 1 times, its replays
       none;
    3. each ``dp_impl`` eager and captured beside each other
       (``_ddp_readings``): ms a step, busy share, peak memory, and the
       NCCL kernels of one profiled step (none in a world of one: NCCL
       reduces one rank's buffer in place without a kernel), the captured
       one's equal to the eager one's.

    Then ``torchrun --standalone --nproc_per_node 1`` runs the train CLI
    for one epoch on ``synthetic://512x640/12`` (``TRAIN_CLI_FLAGS``),
    which joins an NCCL group of one rank and trains through
    ``data_parallel``, its steps captured: the first step's host time
    holds its warm-up and capture, the second is a replay."""
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
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        DDP_WARMUP_STEPS,
    )

    def part(fn, steps_eager, captured_runs, what, grouped_eager=0, grouped_captured=0):
        # the steps of gspmd with a one-rank group (grouped_*) take the
        # plain BatchNorm, whose statistics the group all-reduces: no bn_train
        out, counts = _counted(fn)
        n = steps_eager + captured_runs * (DDP_WARMUP_STEPS + 1)
        grouped = grouped_eager + grouped_captured * (DDP_WARMUP_STEPS + 1)
        want = {k: (n - grouped * (k == "bn_train")) * v for k, v in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"ddp {what}: launches {counts}, want {want}")
        return out, counts

    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        def make_model():
            return MVS4Net(dtu_model_config(), device=dev,
                           generator=torch.Generator().manual_seed(SEED + 5))

        bare_steps = checks.DDP_BARE_RUNS * DP_STEPS
        check, counts = part(
            lambda: checks.check_ddp_step(dev, make_model, batch, DP_STEPS, DP_IMPLS),
            bare_steps + len(DP_IMPLS) * DP_STEPS, 0, "eager check")
        # the captured check: per form GRAPH_EAGER_RUNS eager runs and one
        # captured run, gspmd's second captured run without the group
        gspmd = "gspmd" in DP_IMPLS
        graph_check, graph_counts = part(
            lambda: checks.check_graph_ddp_step(dev, make_model, batch, DP_STEPS, DP_IMPLS),
            bare_steps + len(DP_IMPLS) * checks.GRAPH_EAGER_RUNS * DP_STEPS,
            len(DP_IMPLS) + gspmd, "captured check",
            grouped_eager=gspmd * checks.GRAPH_EAGER_RUNS * DP_STEPS, grouped_captured=gspmd)
        counts = {k: v + graph_counts[k] for k, v in counts.items()}
        forms = {}
        for dp_impl in DP_IMPLS:
            forms[dp_impl] = {mode: _ddp_readings(dev, make_model, batch, dp_impl,
                                                  mode == "captured")
                              for mode in ("eager", "captured")}
            eager, captured = forms[dp_impl]["eager"], forms[dp_impl]["captured"]
            counts = {k: v + eager["launches_first_call"][k]
                      + captured["launches_first_call"][k] for k, v in counts.items()}
            if captured["graphs"] != 1 or eager["graphs"] != 0:
                raise AssertionError(f"ddp {dp_impl}: graphs eager {eager['graphs']}, "
                                     f"captured {captured['graphs']}")
            if captured["nccl_kernels_one_step"] != eager["nccl_kernels_one_step"]:
                raise AssertionError(f"ddp {dp_impl}: NCCL kernels of a replay "
                                     f"{captured['nccl_kernels_one_step']}, of an eager step "
                                     f"{eager['nccl_kernels_one_step']}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

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
            "dtype": "bfloat16", **check, "captured_check": graph_check, "forms": forms,
            "ddp_warmup_steps": DDP_WARMUP_STEPS, "launches": counts,
            "torchrun": {"seconds": torchrun_s,
                         "loss_per_step": [r["loss"] for r in records if r["mode"] == "train"],
                         "step_ms": [r["step_s"] * 1e3 for r in records
                                     if r["mode"] == "train"],
                         "test_step_ms": [r["step_s"] * 1e3 for r in records
                                          if r["mode"] == "test"],
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


def drive_debug(dev):
    """The eval CLI with ``--debug_model 255`` at the pipeline's shape
    (``cli.test.main`` in this process: the scripts/eval_dtu.sh model in
    float32 with the CLI's seed-0 weights, ``--run_gendepth`` over an
    eval-layout scene of 4 views at 512x640, ``_eval_fixture``), on the card
    with its launches counted (the 4 views' forwards and the dump's: its
    forward's launches, ``norm_act`` at each BatchNorm that bit 0
    recomputes, and K4 for each warped view of bit 5 and each correlation
    of bit 6), and with ``--device cpu``; the
    card's dumps held to the CPU's (``checks.compare_debug_dumps``). The
    scene and the outputs live in a temporary directory (the dumps are
    hundreds of MB at this size) and are removed."""
    import glob
    import shutil
    import tempfile

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
        written, seconds = {}, {}
        for key, extra in (("cpu", ["--device", "cpu"]), ("card", [])):     # counts: the card's
            out = os.path.join(root, key)
            t0 = time.perf_counter()
            _, counts = _counted(lambda: eval_cli.main(flags + ["--outdir", out] + extra))
            seconds[key] = time.perf_counter() - t0
            written[key] = {os.path.basename(p)[len("eval_scan1_"):-len(".npy")]: p
                            for p in glob.glob(os.path.join(out, "debug", "eval_scan1_*.npy"))}
        # the views' captured forward: its first call's warm-up and capture
        # (the other views replay); then the dump's eager forward, whose
        # bit-0 hooks recompute every block's BatchNorm with the library
        # (utils/debug._block_parts): norm_act once more at each BatchNorm
        # of a forward, those K6 folds included
        per_view = PIPELINE_LAUNCHES_PER_VIEW
        want = {k: 3 * n for k, n in per_view.items()}
        want["warp_fwd"] += 2 * 4 * (PIPELINE_V - 1)
        want["norm_act"] += per_view["norm_act"] + per_view["band_conv"]
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


def drive_drivers(dev):
    """The port's drivers as a user runs them: ``bench`` at its pinned values
    (its last line held to the metric's keys: a positive rate, three groups,
    the card's name); one forward of ``graft_entry.entry()``'s ``fn`` at the
    bench shape, its launches counted (twice ``EVAL_LAUNCHES``: the call
    captures, its warm-up and its capture each launching every kernel; a
    second call replays and counts none),
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
    # the entry path, counted: its first call captures
    (depth, conf), counts = _counted(lambda: fn(*args))
    want = {k: 2 * n for k, n in EVAL_LAUNCHES.items()}   # the warm-up's and the capture's
    if counts != want:
        raise AssertionError(f"entry(): launches of its first call {counts}, want {want}")
    if any(_counted(lambda: fn(*args))[1].values()):      # a replay: no wrapper runs
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



def drive_graphs(dev, eager_pipeline, drivers):
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

    totals = {}

    def fresh():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def counted(fn, want, what):
        def timed():
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (out, seconds), counts = _counted(timed)
        if counts != want:
            raise AssertionError(f"graphs {what}: launches {counts}, want {want}")
        _add(totals, counts)
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

# the kernels line, a row a kernel of ops/_build.KERNELS: (name, the JAX
# package's Pallas kernel it replaces (None where none stood: XLA fused the
# eval and train-mode BatchNorm into their neighbours, the JAX DCN and
# ConvNeXt blocks are plain jnp and flax), the JAX
# kernels it also serves, the row set of its main sums (timed per eval
# forward or train step), the variant of checks.VARIANTS whose counted
# forward and step give its launches_eval and launches_train (None: the
# flagship's), the key of its rows' largest error (``max_abs_err`` over the
# bf16 rows; ``max_share_of_limit`` where a row's error is its share of an
# element-wise limit), {key: row set} of its other sums)
KERNEL_TABLE = (
    ("warp_cor", "warp_fwd_v3.py:438", ["warp_fwd_v3.py:522 (with ref, via warp_mxu.warp_cor_v3)"],
     "eval", None, "max_abs_err",
     {"full_range": "eval_full_range", "pipeline_float32_view": "pipeline_float32"}),
    ("topdown", "topdown_fused.py:317", ["topdown_fused.py:727 (topdown_fused_level mode v2)"],
     "eval", None, "max_abs_err",
     {"train_step": "train", "pipeline_float32_view": "pipeline_float32"}),
    ("warp_bwd", "warp_xband_bwd.py:410", ["warp_xband_bwd.py:467 (modes v1-v4)"],
     "train", None, "max_abs_err", {"full_range": "full_range"}),
    ("warp_fwd", "warp_fwd_v3.py:522 (no ref, via warp_mxu._warp_v3)",
     ["warp_xband_kernel.py:111", "warp_kernel.py:83"],
     "train", None, "max_abs_err", {"full_range": "full_range"}),
    ("attn_fuse", "attn_fuse.py:98", [], "eval", None, "max_abs_err",
     {"pipeline_float32_view": "pipeline_float32", "workspace": "workspace"}),
    ("band_conv", "reg_band_proto.py:89", [], "eval", None, "max_abs_err",
     {"float32_forward": "eval_float32", "pipeline_float32_view": "pipeline_float32",
      "asff_expand": "asff_eval", "asff_expand_float32": "asff_eval_float32"}),
    ("norm_act", None, [], "eval", None, "max_share_of_limit",
     {"float32_forward": "eval_float32", "pipeline_float32_view": "pipeline_float32"}),
    ("deform_conv", None, [], "eval", "dcn", "max_share_of_limit",
     {"offsets_4px": "eval_offsets_4px"}),
    ("bn_train", None, [], "train", None, "max_share_of_limit", {}),
    ("convnext_block", None, [], "eval", "fpn_convnext4", "max_share_of_limit", {}),
)


def _per_run(rows):
    """Sums over the timed rows of each set, per run of the set's path
    (times the rows' launches per run): the kernel's time back to back from
    the host (``ms``) and its device time (``device_ms``), the plain
    version's, the bound and its parts, its operations at the float32 CUDA
    cores' rate (``cuda_core_bound_ms``), the library yardstick's from the
    host and on the device (None if a row has none), and where every row
    has them the unfused route's time (``unfused_ms``) and the offsets read
    besides (``offset_bytes``)."""
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
                 "library_device_ms": total("library_device_ms") if lib else None,
                 "cuda_core_bound_ms": total("ops") / FP32_FLOPS * 1e3,
                 **{k: total(k) for k in ("unfused_ms", "offset_bytes")
                    if all(k in r for r in timed)}}
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
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    EVAL_LAUNCHES["band_conv"] = VAL_LAUNCHES["band_conv"] = _k6_launches(torch.bfloat16)
    PIPELINE_LAUNCHES_PER_VIEW["band_conv"] = _k6_launches(torch.float32)
    EVAL_LAUNCHES["norm_act"] = VAL_LAUNCHES["norm_act"] = _norm_act_launches(dtu_model_config())
    TRAIN_LAUNCHES["bn_train"] = _bn_train_launches(dtu_model_config())
    PIPELINE_LAUNCHES_PER_VIEW["norm_act"] = _norm_act_launches(checks.eval_dtu_config())
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
        + check_band_conv(dev) + check_norm_act(dev, batch) + check_attn_fuse_workspace(dev)
    rows += check_deform_conv(dev, batch) + check_convnext_block(dev, batch) \
        + check_bn_train(dev, train_batch)
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
        out, counts = _counted(lambda: model(*args))      # the main path, counted
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
        round_ms, timed_counts = _counted(
            lambda: [_time_ms(lambda: model(*args), reps) for _ in range(rounds)])
        fwd_ms = sorted(round_ms)[rounds // 2]
        calls = rounds * (reps + 1)
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
        "launches_per_forward": counts, "norm_act_launches_per_forward": counts["norm_act"],
        "timed_forwards": reps * rounds,
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
        train, train_profile, train_counts = drive_train(dev, train_batch)
    print(json.dumps({"train": train}))
    print(json.dumps({"train_profile": train_profile}))
    del train_batch
    torch.cuda.empty_cache()
    with graphs.eager():
        pipeline, pipeline_counts = drive_pipeline(dev)
    print(json.dumps({"pipeline": pipeline}))
    torch.cuda.empty_cache()
    train_cli = drive_train_cli()
    print(json.dumps({"train_cli": train_cli}))
    torch.cuda.empty_cache()
    batch = _scene(B, V, H, W, dev)
    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    t0 = time.perf_counter()
    with graphs.eager():
        variant_counts, variant_launches = drive_variants(dev, batch, train_batch)
    print(json.dumps({"variants": {"count": len(checks.VARIANTS),
                                   "wall_s": time.perf_counter() - t0,
                                   "launches": variant_counts}}))
    del batch, train_batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    space, space_counts = drive_space(dev, space_rows := [])
    space["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"space_kernel_shapes": space_rows}))
    print(json.dumps({"space": space}))
    rows += space_rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_batch = _scene(TRAIN_B, TRAIN_V, H, W, dev)
    ddp, ddp_counts = drive_ddp(dev, train_batch)
    ddp["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"ddp": ddp}))
    del train_batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    debug, debug_counts = drive_debug(dev)
    debug["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"debug": debug}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    drivers, drivers_counts = drive_drivers(dev)
    drivers["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"drivers": drivers}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    graphs_line, graphs_counts = drive_graphs(dev, pipeline, drivers)
    graphs_line["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"graphs": graphs_line}))

    phases = {"eval": counts, "train": train_counts, "pipeline": pipeline_counts,
              "variants": variant_counts, "space": space_counts, "ddp": ddp_counts,
              "debug": debug_counts, "drivers": drivers_counts,
              # the graphs phase's counted first calls: each captures, and
              # its eager warm-up and its capture launch every kernel once
              "graphs": graphs_counts}
    kernel_line = []
    for name, replaces, also_serves, row_set, variant, error, extra_sets in KERNEL_TABLE:
        mine = [r for r in rows if r["kernel"] == name]
        sums = _per_run(mine)
        own = variant_launches[variant] if variant else {"eval": counts, "train": train_counts}
        errors = [r["max_abs_diff"] for r in mine
                  if error == "max_share_of_limit" or r["dtype"] == "bfloat16"]
        library_shares = [r["library_share_of_limit"] for r in mine
                          if "library_share_of_limit" in r]
        kernel_line.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{name}.cu",
            "replaces": None if replaces is None else f"{JAX_PKG_OPS}/{replaces}",
            "also_serves": [f"{JAX_PKG_OPS}/{a}" for a in also_serves],
            "launches": sum(c[name] for c in phases.values()),
            **{f"launches_{phase}": c[name] for phase, c in phases.items()},
            # a kernel timed on a variant's forward counts these there
            "launches_eval": own["eval"][name], "launches_train": own["train"][name],
            "launches_pipeline_view": pipeline["launches_per_view"][name],
            "launches_train_cli": sum(c[name] for c in train_cli["launches"].values()),
            "timed_per": ("eval forward" if row_set == "eval" else "train step")
                         + (f" of the {variant.upper()} model" if variant else ""),
            error: max(errors),
            # ms, plain_ms, bound_ms and the library's from the host; device_ms
            # and library_device_ms the same launches and library calls on
            # the device (20 of each captured in one CUDA graph): ``ms``
            # includes the host's time per call where that is longer
            **sums[row_set],
            **{key: sums[s] for key, s in extra_sets.items()},
            **({"library_max_share_of_limit": max(library_shares)} if library_shares else {}),
            # the same path at FPN base 4 and 16, through the generic
            # instances, and the row windows of the space phase, per
            # sharded forward
            "other_widths": {k: v for k, v in sums.items() if "_base" in k},
            "space_windows": {k: v for k, v in sums.items() if k.startswith("space_")},
        })
    print(json.dumps({"kernels": kernel_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
