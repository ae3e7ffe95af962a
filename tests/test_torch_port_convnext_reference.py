"""The port's MVSTER with the patchify ConvNeXt pyramid
(``mvster_convnext4_bf16`` of the benchmark) against its plain reference
(``benchmark/reference/mvster_convnext.py``) on the CPU, in float32: one
block, the whole eval forward, controls that take the blocks' MLP branch
away or round its input to bf16, the blocks' span and counter, the blocks'
count (``benchmark/counts/convnext.py``) against ``FlopCounterMode``, and
the driver's corrected counts (``benchmark/drivers/eval_convnext.py``)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import compare, harness, program
from benchmark.counts import convnext as convnext_counts
from benchmark.counts import roofline
from benchmark.reference import mvster_convnext
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
    make_eval_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.fpn import (
    ConvNeXt4Block,
    ConvNeXtBlock,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import trace

CELL = "eval_convnext4_bf16"
CONFIG = {**harness.load_json(harness.find("configs", "mvster_convnext4_bf16")),
          "dtype": "float32"}
B, V, H, W = 1, 3, 64, 64
# one block in float32: the port's channels-last convs, F.layer_norm and
# F.gelu against the reference's NCHW convs and its LayerNorm and GELU by
# their equations; each output element sums ~200 float32 products, whose
# order differs between the two, so they part by a few 1e-7 of the
# output's largest value; 1e-5 holds that with room and nothing more
BLOCK_TOL = 1e-5
F32_SPEC = harness.load_json(harness.find("workloads", "eval_dtu_f32"))


def _block_case(dim=8, seed=3):
    """A seeded ``ConvNeXt4Block`` (``harness.make_weights``, so ``gamma``
    and the LayerNorm weight are N(0, 1) as in the cell), its reference
    parameters under ``feature.conv1.``, and an input of 2 x 18 x 22
    pixels."""
    block = ConvNeXt4Block(dim).eval()
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in block.state_dict().items()}
    p = harness.make_weights(shapes, seed, "cpu")
    block.load_state_dict(p)
    x = torch.randn(2, 18, 22, dim, generator=torch.Generator().manual_seed(seed + 1))
    return block, {f"feature.conv1.{k}": v for k, v in p.items()}, x


def _reference_block(p, x, net_cls=mvster_convnext.Net):
    return net_cls(p, CONFIG).block(x.permute(0, 3, 1, 2), "feature.conv1")


def _block_gap(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_convnext4_block_matches_the_reference():
    block, p, x = _block_case()
    with torch.no_grad():
        got = block(x).permute(0, 3, 1, 2)
        want = _reference_block(p, x)
    assert got.shape == (2, 16, 9, 11)
    assert _block_gap(got, want) <= BLOCK_TOL


class _Bf16BranchNet(mvster_convnext.Net):
    """The reference with the MLP's input, the LayerNorm's output, rounded
    to bf16."""

    def pointwise(self, x, name):
        if name.endswith("pwconv1"):
            x = x.to(torch.bfloat16).float()
        return super().pointwise(x, name)


@pytest.mark.parametrize("control", ["no_branch", "bf16_branch_input"])
def test_a_reference_without_the_exact_branch_fails_the_block_comparison(control):
    """The same block against the reference without its MLP branch
    (``gamma`` zeroed), or with the branch's input rounded to bf16: the
    comparison that holds above fails, so it sees the branch."""
    block, p, x = _block_case()
    net_cls = mvster_convnext.Net
    if control == "no_branch":
        p = {**p, "feature.conv1.gamma": torch.zeros_like(p["feature.conv1.gamma"])}
    else:
        net_cls = _Bf16BranchNet
    with torch.no_grad():
        got = block(x).permute(0, 3, 1, 2)
        want = _reference_block(p, x, net_cls)
    assert _block_gap(got, want) > 10 * BLOCK_TOL


def _ctx(seed: int):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    mix = harness.load_json(harness.find("traffic", cell["traffic"]))
    return SimpleNamespace(seed=seed, device="cpu", traffic={**mix, **mix["tiny"]})


@pytest.fixture(scope="module")
def forward_case():
    """The port's eval forward (``make_eval_forward``, eager on the CPU) of
    a seeded B1 V3 64x64 batch, with the recorder's snapshot of that one
    forward."""
    ctx = _ctx(2 ** 31 + 31)
    model, weights = program.build_model(CONFIG, ctx.seed, "cpu")
    batch = program.scenes(ctx, B, V)
    forward = make_eval_forward(model)
    trace.reset()
    got = forward(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    snap = trace.snapshot()
    return SimpleNamespace(got=got, snap=snap, weights=weights, batch=batch)


def _numbers(case, weights):
    """``compare.DepthGap``'s numbers of the port's forward against the
    reference's on ``weights``, at the float32 cells' ``sure``."""
    out = mvster_convnext.Net(weights, CONFIG).forward(
        case.batch["imgs"], case.batch["proj_matrices"], case.batch["depth_values"])
    stages = [out[f"stage{s}"] for s in (1, 2, 3, 4)]
    want = {"confidence": out["stage4"]["photometric_confidence"],
            "stage_depths": [o["depth"] for o in stages],
            "stage_scores": [o["score"] for o in stages]}
    gap = compare.DepthGap(**F32_SPEC["sure"])
    gap.add(case.got["stage_depths"], case.got["confidence"], want)
    assert gap.bad_maps == 0
    return gap.numbers()


def test_convnext_model_eval_forward_matches_the_reference(forward_case):
    """Every stage's depth choice and the stage-4 confidence within the
    float32 cells' limits (``workloads/eval_dtu_f32.json``: float32 on both
    sides decides the same among the hypotheses but for near-ties under
    1e-5 of the score level, and the confidences part by under 1.5e-5)."""
    numbers = _numbers(forward_case, forward_case.weights)
    assert all(numbers[k] <= limit for k, limit in F32_SPEC["limits"].items()), numbers


def test_a_reference_without_the_branch_fails_the_model_comparison(forward_case):
    """The reference's blocks without their MLP branch (every ``gamma``
    zeroed): the comparison above fails by every limit."""
    weights = {k: torch.zeros_like(v) if k.endswith(".gamma") else v
               for k, v in forward_case.weights.items()}
    numbers = _numbers(forward_case, weights)
    assert all(numbers[k] > limit for k, limit in F32_SPEC["limits"].items()), numbers


def test_convnext_span_and_pixels_match_the_count(forward_case):
    """One eager forward opens the ``convnext`` span once a block and adds
    each block's output pixels to ``convnext.pixels``, as
    ``counts/convnext.py`` counts them."""
    want = convnext_counts.totals(convnext_counts.blocks(B, V, H, W, CONFIG["fpn_base_channel"],
                                                         CONFIG["dtype"]))
    assert forward_case.snap["spans"]["convnext"]["count"] == 3
    assert forward_case.snap["counters"]["convnext.pixels"] == want["pixels"] == B * V * (
        32 * 32 + 16 * 16 + 8 * 8)


def test_the_downsampling_block_records_its_span_and_pixels():
    """The non-patchify ``ConvNeXtBlock`` (``fpn_convnext``) records as the
    patchify one does: one span, its output's pixels (7x7 at stride 2,
    padding 3: an odd side rounds up)."""
    block = ConvNeXtBlock(4).eval()
    trace.reset()
    with torch.no_grad():
        y = block(torch.randn(2, 9, 12, 4))
    snap = trace.snapshot()
    assert y.shape == (2, 5, 6, 8)
    assert snap["spans"]["convnext"]["count"] == 1
    assert snap["counters"]["convnext.pixels"] == 2 * 5 * 6


def test_convnext_count_matches_the_flop_counter():
    """The blocks' convolution FLOPs (patchify, grouped 7x7, pointwise)
    against ``FlopCounterMode`` over the reference's three blocks, exactly:
    the counter counts the convolutions and no LayerNorm, GELU or scale."""
    b = CONFIG["fpn_base_channel"]
    pieces = convnext_counts.blocks(B, V, H, W, b, CONFIG["dtype"])
    shapes = {}
    for i, dim in enumerate((b, 2 * b, 4 * b), start=1):
        shapes.update({f"feature.conv{i}.{k}": (tuple(v.shape), v.dtype)
                       for k, v in ConvNeXt4Block(dim).state_dict().items()})
    net = mvster_convnext.Net(harness.make_weights(shapes, 5, "cpu"), CONFIG)
    x = torch.randn(B * V, b, H, W)
    for i, piece in enumerate(pieces, start=1):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            x = net.block(x, f"feature.conv{i}")
        assert counter.get_total_flops() == piece["conv_flops"], piece["name"]
        assert x.shape[0] * x.shape[2] * x.shape[3] == piece["pixels"]


def test_the_driver_counts_the_convnext_pyramid():
    """``eval_convnext``'s counts at the cell's size: no K6 row for FPN4's
    ``conv1.x``-``conv3.x`` (K6 runs on ``conv0.0``, ``conv0.1`` and the
    four Reg2D ``conv0``: 6 rows), every other row kept; and the FLOPs a
    forward with FPN4's stem stages swapped for the blocks."""
    drv = harness.load_module(harness.find("drivers", "eval_convnext", ".py"))
    cfg = harness.load_json(harness.find("configs", "mvster_convnext4_bf16"))
    shape = (4, 4, 512, 640)
    fpn4 = roofline.kernel_pieces(cfg, *shape, train=False)
    got = drv.kernel_pieces(fpn4)
    k6 = [p["name"] for p in got if p["name"].startswith("K6 ")]
    assert k6 == ["K6 band conv conv0.0", "K6 band conv conv0.1"] + [
        f"K6 band conv reg{s}.conv0" for s in (1, 2, 3, 4)]
    assert [p for p in fpn4 if not p["name"].startswith("K6 ")] == [
        p for p in got if not p["name"].startswith("K6 ")]
    stem = convnext_counts.totals(convnext_counts.blocks(*shape, 8, "bfloat16"))
    assert 19e9 < stem["conv_flops"] < 20e9 and 215e6 < stem["bytes"] < 225e6
    fpn4_stem = roofline.pieces(cfg, *shape)[0]
    conv0 = 2.0 * 16 * 512 * 640 * 9 * 8 * (3 + 8)
    assert convnext_counts.fpn4_stages_flops(cfg, *shape) == pytest.approx(
        fpn4_stem["conv_flops"] - conv0)


def test_convnext_reference_is_eval_only():
    with pytest.raises(ValueError):
        mvster_convnext.Net({}, CONFIG, train=True)
