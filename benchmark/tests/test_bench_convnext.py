"""The cell ``eval_convnext4_bf16`` on the CPU, at its ``tiny`` size:
``correct`` false when the timed path's answer is altered, the ConvNeXt
driver's check and control held to the ConvNeXt reference, its counts put
right for the pyramid, and its three metrics on a profile; without the
program's ``mvster.convnext`` ranges they read nothing."""

from __future__ import annotations

import pytest
from test_bench_dcn import _ctx, _driver, _events

from benchmark import faults, harness

CELL = "eval_convnext4_bf16"
METRICS = ("convnext_ms.eval", "convnext_share.eval", "convnext_roofline.eval")


def test_an_altered_answer_is_not_correct():
    drv = _driver("eval_convnext")
    assert drv.run(_ctx(CELL, 22))["correct"]
    res = drv.run(_ctx(CELL, 22), fault=faults.altered_answer)
    assert not res["correct"], res["checks"]


def test_the_convnext_driver_checks_against_the_convnext_reference(monkeypatch):
    """The check and the control run the ConvNeXt reference's blocks,
    three a forward, and the flagship's reference is back in place after
    each; the run's counts are the pyramid's."""
    from benchmark import compare
    from benchmark.counts import convnext, roofline
    from benchmark.reference import mvster, mvster_convnext

    calls = []
    block = mvster_convnext.Net.block

    def counted(self, x, name):
        calls.append(name)
        return block(self, x, name)

    monkeypatch.setattr(mvster_convnext.Net, "block", counted)
    drv = _driver("eval_convnext")
    ctx = _ctx(CELL, 22)
    checked = min(ctx.spec["check_batches"], ctx.traffic["pool"])
    res = drv.run(ctx)
    assert len(calls) == 3 * checked and compare.Net is mvster.Net
    drv.control(ctx, "fp8")
    assert len(calls) == 3 * 3 * checked and compare.Net is mvster.Net

    mix, cfg = ctx.traffic, ctx.config
    shape = (mix["batch"], mix["views"], mix["height"], mix["width"])
    stem = convnext.totals(convnext.blocks(*shape, cfg["fpn_base_channel"], cfg["dtype"]))
    want = (roofline.totals(roofline.pieces(cfg, *shape))["flops"] + stem["flops"]
            - convnext.fpn4_stages_flops(cfg, *shape))
    assert res["flops_per_iter"] == pytest.approx(want)
    assert not any(p["name"].startswith(("K6 band conv conv1", "K6 band conv conv2",
                                         "K6 band conv conv3")) for p in res["kernel_pieces"])
    assert res["convnext"] == {"bound_ms": stem["bound_ms"]}


def test_the_profile_is_read_over_the_convnext_ranges():
    """The driver's copy of ``eval_dcn``'s profile reads ``mvster.convnext``
    ranges, and ``eval_dcn``'s own copy still reads ``mvster.dcn``."""
    drv = _driver("eval_convnext")
    dcn = _driver("eval_dcn")
    ranged = [dict(e, name="mvster.convnext") if e["name"] == "mvster.dcn" else e
              for e in _events()]
    assert drv.PROFILE.device_seconds(ranged)["heads_s"] == pytest.approx(8e-6)
    assert "heads_s" not in drv.PROFILE.device_seconds(_events())
    assert dcn.device_seconds(_events())["heads_s"] == pytest.approx(8e-6)


def test_convnext_metrics_read_the_profile_and_nothing_without_it():
    def read(name, res):
        return harness.load_module(harness.find("metrics", name, ".py")).read(res)

    res = {"convnext": {"bound_ms": 0.07, "stem_s": 0.035, "forward_s": 0.07, "iters": 5}}
    assert read("convnext_ms.eval", res) == pytest.approx(7.0)
    assert read("convnext_share.eval", res) == pytest.approx(50.0)
    assert read("convnext_roofline.eval", res) == pytest.approx(1.0)
    for res in ({}, {"convnext": {"bound_ms": 0.07}},
                {"convnext": {"bound_ms": 0.07, "forward_s": 0.07, "iters": 5}}):
        assert all(read(n, res) is None for n in METRICS)
