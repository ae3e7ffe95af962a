"""The frozen yardstick against the program's own arithmetic and
PyTorch's FLOP counter, on the CPU."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import classify, roofline
from benchmark.reference.mvster import Net, recipe_loss

B, V, H, W = 1, 2, 64, 64


def _config(name="mvster_dtu_bf16"):
    return harness.load_json(harness.find("configs", name))


def test_eval_count_matches_the_programs_roofline():
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools import (
        roofline as program_roofline,
    )
    from benchmark.program import model_config

    for name in ("mvster_dtu_bf16", "mvster_eval_f32"):
        cfg = _config(name)
        want = program_roofline.pieces(model_config(cfg), B, V, H, W)
        got = roofline.pieces(cfg, B, V, H, W)
        assert [p["name"] for p in got] == [p["name"] for p in want]
        for g, w in zip(got, want):
            for key in ("conv_flops", "other_flops", "bytes", "bound_ms"):
                assert abs(g[key] - w[key]) <= 1e-9 * max(1.0, abs(w[key])), (g["name"], key)


def test_train_count_convolutions_match_the_flop_counter():
    """The train count's convolution FLOPs (forward, and a backward of twice
    them) against ``FlopCounterMode`` over one forward and backward of the
    reference in train mode. Margin 2%: the counter skips the input
    gradient of the first convolution (the images need none) and counts
    the few small matmuls of the camera algebra, which the count leaves
    out."""
    cfg = _config()
    shapes = {k: (v, torch.float32) for k, v in _state_shapes().items()}
    weights = harness.make_weights(shapes, 7, "cpu")
    params = {k: v.requires_grad_(v.is_floating_point() and "running" not in k)
              for k, v in weights.items()}
    from benchmark.traffic import plane_scenes
    mix = harness.load_json(harness.find("traffic", "dtu_train_b6v5"))
    batch = plane_scenes.render(plane_scenes.scene_params(harness.seed_rng(7, 2), B, V, mix),
                                V, H, W, mix["depth_range"], "cpu", with_targets=True)
    counter = FlopCounterMode(display=False)
    with counter:
        out = Net(params, cfg, train=True).forward(batch["imgs"], batch["proj_matrices"],
                                                     batch["depth_values"])
        loss, _ = recipe_loss(out, batch["depth"], batch["mask"], 0.003, 1.0, 10)
        loss.backward()
    counts = counter.get_flop_counts()["Global"]
    conv_ops = {k: v for k, v in counts.items() if "convolution" in str(k)}
    measured = sum(conv_ops.values())
    pieces = roofline.train_pieces(cfg, B, V, H, W)
    expected = sum(p["conv_flops"] for p in pieces)
    assert abs(measured - expected) <= 0.02 * expected, (measured, expected)


def _state_shapes():
    from benchmark.program import model_config
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    model = MVS4Net(model_config(_config()), device="cpu")
    return {k: tuple(v.shape) for k, v in model.state_dict().items() if v.is_floating_point()}


def test_classifier_matches_the_programs_trace_table():
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools import trace_table

    names = [
        "void (anonymous namespace)::warp_cor_kernel<8, 8>(float const*)",
        "void (anonymous namespace)::warp_cor_kernel_any(float const*)",
        "void (anonymous namespace)::topdown_kernel_mma<8, 8>(__nv_bfloat16 const*)",
        "void (anonymous namespace)::topdown_kernel_gen<float, 1>(float const*)",
        "void (anonymous namespace)::warp_bwd_kernel<4>(float const*)",
        "void (anonymous namespace)::warp_fwd_kernel<8>(float const*)",
        "void (anonymous namespace)::attn_fuse_kernel<4>(float const*)",
        "void (anonymous namespace)::band_conv_kernel_mma<8, 1>(__nv_bfloat16 const*)",
        "void (anonymous namespace)::band_conv_kernel_f32<1>(float const*)",
        "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x32x64",
        "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int)",
        "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16>",
        "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32",
        "ampere_sgemm_128x64_tn",
        "Memcpy DtoD (Device -> Device)",
        "Memset (Device)",
        "void at::native::elementwise_kernel<128, 2, MulFunctor<float>>",
        "void at::native::reduce_kernel<512, 1>(float)",
        "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>",
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
        "void softmax_warp_forward<float, float, float, 3, false>(float*)",
    ]
    fams = classify.families()
    for name in names:
        assert classify.category(name, fams) == trace_table.category(name), name
