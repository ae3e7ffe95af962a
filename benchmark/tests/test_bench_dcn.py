"""The cells ``eval_dcn_bf16`` and ``eval_tanks_bf16`` on the CPU, at their
``tiny`` sizes: ``correct`` false when the timed path's answer is altered,
the DCN driver's check and control held to the DCN reference, and its
reading of a profile (``drivers/eval_dcn.py``) and its three metrics on a
synthetic trace; without the program's ``mvster.dcn`` ranges they read
nothing."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import faults, harness

ROOT = harness.ROOT


def _ctx(cell: str, seed: int):
    """As ``test_bench_harness._ctx``: the cell's tiny sizes in float32."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    config = {**harness.load_json(harness.find("configs", entry["config"])), "dtype": "float32"}
    mix = harness.load_json(harness.find("traffic", entry["traffic"]))
    spec = harness.load_json(harness.find("workloads", cell))
    return SimpleNamespace(name=cell, seed=seed, seconds=0.5, trace=False, device="cpu",
                           tiny=True, config=config, traffic={**mix, **mix["tiny"]}, spec=spec,
                           t_start=time.perf_counter())


def _driver(name: str):
    return harness.load_module(harness.find("drivers", name, ".py"))


@pytest.mark.parametrize("cell", ["eval_dcn_bf16", "eval_tanks_bf16"])
def test_an_altered_answer_is_not_correct(cell):
    drv = _driver(harness.load_json(harness.find("workloads", cell))["driver"])
    assert drv.run(_ctx(cell, 22))["correct"]
    res = drv.run(_ctx(cell, 22), fault=faults.altered_answer)
    assert not res["correct"], res["checks"]


def test_the_dcn_driver_checks_against_the_dcn_reference(monkeypatch):
    """The check and the control run the DCN reference's heads, four a
    forward, and the flagship's reference is back in place after each."""
    from benchmark import compare
    from benchmark.reference import mvster, mvster_dcn

    calls = []
    head = mvster_dcn.Net.head

    def counted(self, x, name):
        calls.append(name)
        return head(self, x, name)

    monkeypatch.setattr(mvster_dcn.Net, "head", counted)
    drv = _driver("eval_dcn")
    ctx = _ctx("eval_dcn_bf16", 22)
    checked = min(ctx.spec["check_batches"], ctx.traffic["pool"])
    drv.run(ctx)
    assert len(calls) == 4 * checked and compare.Net is mvster.Net
    drv.control(ctx, "fp8")
    assert len(calls) == 3 * 4 * checked and compare.Net is mvster.Net


def _x(name, ts, dur, cat, tid=1, corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(with_ranges=True):
    """Two launches inside a ``mvster.dcn`` range (one by the runtime, one
    by the driver API), one outside it, one on another thread inside its
    time; their kernels take 3, 5, 7 and 11 us, and a copy 13 us."""
    ev = [_x("cudaLaunchKernel", 12, 1, "cuda_runtime", corr=1),
          _x("cuLaunchKernel", 14, 1, "cuda_driver", corr=2),
          _x("cudaLaunchKernel", 30, 1, "cuda_runtime", corr=3),
          _x("cudaLaunchKernel", 13, 1, "cuda_runtime", tid=2, corr=4),
          _x("cudaMemcpyAsync", 31, 1, "cuda_runtime", corr=5),
          _x("k1", 40, 3, "kernel", tid=7, corr=1), _x("k2", 44, 5, "kernel", tid=7, corr=2),
          _x("k3", 50, 7, "kernel", tid=7, corr=3), _x("k4", 60, 11, "kernel", tid=7, corr=4),
          _x("Memcpy DtoD", 72, 13, "gpu_memcpy", tid=7, corr=5)]
    if with_ranges:
        ev.append(_x("mvster.dcn", 10, 10, "user_annotation"))
    return ev


def test_device_seconds_of_the_dcn_ranges():
    drv = _driver("eval_dcn")
    got = drv.device_seconds(_events())
    assert got["forward_s"] == pytest.approx(39e-6)
    assert got["heads_s"] == pytest.approx(8e-6)
    assert "heads_s" not in drv.device_seconds(_events(with_ranges=False))


def test_dcn_metrics_read_the_profile_and_nothing_without_it():
    def read(name, res):
        return harness.load_module(harness.find("metrics", name, ".py")).read(res)

    res = {"dcn": {"bound_ms": 0.5, "heads_s": 0.2, "forward_s": 0.25, "iters": 4}}
    assert read("dcn_ms.eval", res) == pytest.approx(50.0)
    assert read("dcn_share.eval", res) == pytest.approx(80.0)
    assert read("dcn_roofline.eval", res) == pytest.approx(1.0)
    for res in ({}, {"dcn": {"bound_ms": 0.5}},
                {"dcn": {"bound_ms": 0.5, "forward_s": 0.25, "iters": 4}}):
        assert all(read(n, res) is None
                   for n in ("dcn_ms.eval", "dcn_share.eval", "dcn_roofline.eval"))
