"""The port's MVSTER with DCN heads (``mvster_dcn_bf16`` of the benchmark)
against its plain reference (``benchmark/reference/mvster_dcn.py``) on the
CPU, in float32: one head, the whole eval forward, the heads' span and
counter, the heads' count (``benchmark/counts/dcn.py``) against
``FlopCounterMode``, and the eval CLI with ``--dcn``."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import compare, harness, program
from benchmark.counts import dcn as dcn_counts
from benchmark.reference import mvster_dcn
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
    make_eval_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.fpn import NADCN
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import trace

CONFIG = {**harness.load_json(harness.find("configs", "mvster_dcn_bf16")), "dtype": "float32"}
B, V, H, W = 1, 3, 64, 64
# one head at float32: the port samples by gathers at pixel coordinates,
# the reference by F.grid_sample's normalised round trip, which moves a
# coordinate by ~1e-7 of the width; 1e-5 of the output's largest value
# holds that and nothing more
HEAD_TOL = 1e-5
F32_SPEC = harness.load_json(harness.find("workloads", "eval_dtu_f32"))


def _head_weights(C: int, seed: int):
    """A head's seeded weights (``harness.make_weights``) with offsets of
    order a pixel: the offset conv's weight at three times its fan-in
    scale, and taps 0 and 4 on exact integer displacements (their rows
    zeroed, integer biases), tap 0 two rows up and tap 4 three columns to
    the right, so that border pixels sample outside the image."""
    head = NADCN(C).eval()
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in head.state_dict().items()}
    p = harness.make_weights(shapes, seed, "cpu")
    w, b = p["2.conv_offset.weight"], p["2.conv_offset.bias"]
    w *= 3.0
    w[[0, 1, 8, 9]] = 0.0
    b[[0, 1, 8, 9]] = torch.tensor([-2.0, 1.0, 0.0, 3.0])
    head.load_state_dict(p)
    return head, {f"feature.dcn1.{k}": v for k, v in p.items()}


def _reference_head(p, x):
    return mvster_dcn.Net(p, CONFIG).head(x.permute(0, 3, 1, 2), "feature.dcn1")


def _head_case(C=6):
    head, p = _head_weights(C, 3)
    x = torch.randn(4, 10, 12, C, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = head(x).permute(0, 3, 1, 2)
        want = _reference_head(p, x)
    return head, p, x, got, want


def test_dcn_head_matches_the_reference():
    head, p, x, got, want = _head_case()
    with torch.no_grad():
        off = head._modules["2"].conv_offset
        xn = head._modules["0"](x, relu=True)
        offs = torch.nn.functional.conv2d(xn.permute(0, 3, 1, 2), off.weight, off.bias,
                                          padding=1)
    # the case is what the docstring says: offsets of order a pixel, off the
    # grid but for the two integer taps, and taps outside the image
    spread = offs[:, [k for k in range(18) if k not in (0, 1, 8, 9)]]
    assert 0.3 < float(spread.std()) < 3.0
    assert float((spread - spread.round()).abs().min()) < 0.5
    assert (offs[:, 0] == -2.0).all() and (offs[:, 9] == 3.0).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= HEAD_TOL * scale


def test_a_reference_without_offsets_fails_the_head_comparison():
    """The same head against the reference with its offset conv zeroed
    (a plain 3x3 conv): the comparison that holds above fails."""
    _, p, x, got, _ = _head_case()
    p0 = dict(p)
    for k in ("feature.dcn1.2.conv_offset.weight", "feature.dcn1.2.conv_offset.bias"):
        p0[k] = torch.zeros_like(p[k])
    with torch.no_grad():
        want0 = _reference_head(p0, x)
    assert float((got - want0).abs().max()) > 100 * HEAD_TOL * float(want0.abs().max())


def _ctx(seed: int):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}["eval_dcn_bf16"]
    mix = harness.load_json(harness.find("traffic", cell["traffic"]))
    return SimpleNamespace(seed=seed, device="cpu", traffic={**mix, **mix["tiny"]})


@pytest.fixture(scope="module")
def forward_case():
    """The port's eval forward (``make_eval_forward``, eager on the CPU) of
    a seeded B1 V3 64x64 batch, with the recorder's snapshot of that one
    forward."""
    ctx = _ctx(2 ** 31 + 29)
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
    out = mvster_dcn.Net(weights, CONFIG).forward(case.batch["imgs"], case.batch["proj_matrices"],
                                                  case.batch["depth_values"])
    stages = [out[f"stage{s}"] for s in (1, 2, 3, 4)]
    want = {"confidence": out["stage4"]["photometric_confidence"],
            "stage_depths": [o["depth"] for o in stages],
            "stage_scores": [o["score"] for o in stages]}
    gap = compare.DepthGap(**F32_SPEC["sure"])
    gap.add(case.got["stage_depths"], case.got["confidence"], want)
    assert gap.bad_maps == 0
    return gap.numbers()


def test_dcn_model_eval_forward_matches_the_reference(forward_case):
    """Every stage's depth choice, and the stage-4 confidence, within the
    float32 cells' limits (``workloads/eval_dtu_f32.json``: float32 on both
    sides decides the same among the hypotheses but for near-ties under
    1e-5 of the score level)."""
    numbers = _numbers(forward_case, forward_case.weights)
    assert all(numbers[k] <= limit for k, limit in F32_SPEC["limits"].items()), numbers


def test_a_reference_without_offsets_fails_the_model_comparison(forward_case):
    """The reference's heads without their offsets (plain 3x3 convs): the
    comparison above fails by every limit."""
    weights = {k: torch.zeros_like(v) if ".conv_offset." in k else v
               for k, v in forward_case.weights.items()}
    numbers = _numbers(forward_case, weights)
    assert all(numbers[k] > limit for k, limit in F32_SPEC["limits"].items()), numbers


def test_dcn_span_and_samples_match_the_count(forward_case):
    """One eager forward opens the ``dcn`` span once a head and adds each
    head's ``9 N H W`` samples to ``dcn.samples``, as ``counts/dcn.py``
    counts them."""
    want = dcn_counts.totals(dcn_counts.heads(B, V, H, W, CONFIG["fpn_base_channel"],
                                              CONFIG["dtype"]))
    assert forward_case.snap["spans"]["dcn"]["count"] == 4
    assert forward_case.snap["counters"]["dcn.samples"] == want["samples"]


def test_dcn_count_matches_the_flop_counter():
    """The heads' tensor FLOPs (offset conv and contraction) against
    ``FlopCounterMode`` over the reference's four heads, exactly: the
    counter counts the convolution and the contraction's matmul, and no
    sampling (``F.grid_sample`` has no FLOP formula)."""
    b = CONFIG["fpn_base_channel"]
    heads = dcn_counts.heads(B, V, H, W, b, CONFIG["dtype"])
    shapes, inputs = {}, []
    for i, c in enumerate((8 * b, 4 * b, 2 * b, b)):
        head = NADCN(c).eval()
        shapes.update({f"feature.dcn{i + 1}.{k}": (tuple(v.shape), v.dtype)
                       for k, v in head.state_dict().items()})
        inputs.append(torch.randn(B * V, c, H >> (3 - i), W >> (3 - i)))
    net = mvster_dcn.Net(harness.make_weights(shapes, 5, "cpu"), CONFIG)
    for i, (x, piece) in enumerate(zip(inputs, heads)):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            net.head(x, f"feature.dcn{i + 1}")
        assert counter.get_total_flops() == piece["conv_flops"], (i, piece["name"])


def test_dcn_reference_is_eval_only():
    with pytest.raises(ValueError):
        mvster_dcn.Net({}, CONFIG, train=True)


def test_eval_cli_runs_the_dcn_heads(tmp_path):
    """``cli.test --run_gendepth --dcn`` (the scripts/eval_dtu.sh flags,
    float32) on a 4-view 64x128 eval fixture: a finite depth map a view,
    and the heads' span opened by every view's forward."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as eval_cli
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import io
    from test_torch_port_eval import _eval_fixture

    data = tmp_path / "data"
    data.mkdir()
    _eval_fixture(data)
    out = tmp_path / "out"
    trace.reset()
    eval_cli.main((
        f"--dataset=dataloader_eval --dataset_name=dtu --datapath {data} "
        f"--testlist {data / 'test.txt'} --interval_scale=1.0 --max_h 64 --max_w 128 "
        "--run_gendepth --NviewGen 4 --depthgen_thres 0.3 --device cpu --num_worker 0 "
        "--group_cor --group_cor_dim=8,8,4,4 --ndepths=8,8,4,4 --inverse_depth "
        f"--attn_temp 2 --dcn --outdir {out}").split())
    maps = sorted((out / "scan1" / "depth_est").glob("*.pfm"))
    assert len(maps) == 4
    for m in maps:
        depth, _ = io.read_pfm(str(m))
        assert np.isfinite(depth).all() and depth.shape == (64, 128)
    assert trace.snapshot()["spans"]["dcn"]["count"] == 4 * 4
