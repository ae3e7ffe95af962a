"""The readers of the program's spans and counters (``spans.py`` and its
``metrics/``) on a synthetic result and recorder snapshot; without the
program's recorder they read nothing. On the card: the program's spans and
the device trace share one clock.

    python3 -m pytest --noconftest -q -s -m cuda benchmark/tests/test_bench_spans.py
"""

from __future__ import annotations

import gzip
import json
import time

import pytest
import torch

from benchmark import harness, spans

MS = 1_000_000      # ns


def _read(name, res):
    return harness.load_module(harness.find("metrics", name, ".py")).read(res)


def _stat(*durations_s, self_s=None):
    return {"count": len(durations_s), "total_s": sum(durations_s),
            "self_s": sum(durations_s) if self_s is None else self_s,
            "recent_s": list(durations_s)}


@pytest.fixture
def synthetic(monkeypatch):
    """Two profiled iterations: device busy over [0, 1], [2, 3], [5, 6],
    [6.5, 7] and [9, 10] ms; the program's spans ``forward`` over
    [0.5, 4.5] with ``forward.copy_in`` over [1.2, 1.8], ``fusion.download``
    over [6, 6.4] and ``feed`` over [7.5, 8.5]. The inner gaps' middles:
    1.5 in ``forward.copy_in``, 4 in ``forward``, 6.25 in
    ``fusion.download``, 8 in ``feed``."""
    wall0 = time.time_ns()
    base = spans.base_ns({"kernels": [("k", 0.0, 0.0)]}, wall0)
    t0 = wall0 - base

    def at(ms):
        return wall0 + round(ms * MS)

    timeline = [["forward.copy_in", at(1.2), at(1.8)],
                ["forward", at(0.5), at(4.5)],
                ["fusion.download", at(6.0), at(6.4)],
                ["feed", at(7.5), at(8.5)]]
    snap = {"spans": {"forward.copy_in": _stat(1e-3, 3e-3, 2e-3),
                      "forward.wait": _stat(5e-3),
                      "forward.copy_out": _stat(4e-3, 6e-3),
                      "fusion.filter": _stat(7e-3, 9e-3, 8e-3),
                      "fusion.gather": _stat(1e-3),
                      "feed": _stat(0.02, 0.03),
                      "graph.replay": _stat(1e-4, 2e-4, 3e-4),
                      "graph.capture": _stat(2.5, 1.5, self_s=3.0),
                      "kernels.load": _stat(0.25, 0.5)},
            "counters": {"feed.bytes": 236_000_000, "graph.captures": 2,
                         "kernels.built": 3},
            "timeline": timeline, "dropped": 0}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    busy = [(0, 1), (2, 3), (5, 6), (6.5, 7), (9, 10)]
    kernels = [("k", (t0 + a * MS) * 1e-9, (b - a) * 1e-3) for a, b in busy]
    return {"trace": {"kernels": kernels[::-1], "iters": 2, "window_s": 0.01, "busy_s": 0.0045}}


def test_the_readers_on_a_synthetic_snapshot(synthetic):
    want = {"forward_copy_in_ms.cloud": 2.0, "forward_wait_ms.cloud": 5.0,
            "forward_copy_out_ms.cloud": 5.0, "fusion_filter_ms.cloud": 8.0,
            "fusion_gather_ms.cloud": 1.0, "feed_host_ms.train": 25.0, "feed_mb.train": 118.0,
            "replay_host_ms.eval": 0.2, "capture_s": 3.0, "kernel_load_s": 0.75,
            "graph_captures": 2, "kernels_built": 3,
            # gaps of 1, 2, 0.5 and 2 ms over 2 iterations
            "idle_copies_ms.cloud": 0.75, "idle_program_ms.cloud": 2.0,
            "idle_caller_ms.cloud": 0.0, "idle_feed_ms.train": 1.0}
    for name, value in want.items():
        assert _read(name, synthetic) == pytest.approx(value, abs=1e-6), name


def test_the_idle_metrics_share_out_the_inner_idle(synthetic):
    """``idle_copies``, ``idle_program`` and ``idle_caller`` sum to the
    inner idle an iteration; without the ``feed`` span its gap is the
    caller's."""
    snap = spans.snapshot()
    snap["timeline"] = [t for t in snap["timeline"] if t[0] != "feed"]
    parts = [_read(f"idle_{p}_ms.cloud", synthetic) for p in ("copies", "program", "caller")]
    assert parts == pytest.approx([0.75, 1.0, 1.0])
    assert sum(parts) == pytest.approx(5.5 / 2)
    assert _read("idle_feed_ms.train", synthetic) == 0.0


def test_without_the_programs_recorder_nothing_is_read(synthetic, monkeypatch):
    monkeypatch.undo()
    monkeypatch.setattr(spans, "PROGRAM", "no_such_program_package")
    names = [m["name"] for m in harness.load_json(harness.ROOT / "BENCHMARK.json")["per_layer"]
             if harness.find("metrics", m["name"], ".py").read_text().count("spans.")]
    assert len(names) == 16
    for name in names:
        assert _read(name, synthetic) is None, name


def test_without_a_trace_the_idle_metrics_read_nothing(synthetic):
    for name in ("idle_copies_ms.cloud", "idle_program_ms.cloud", "idle_caller_ms.cloud",
                 "idle_feed_ms.train"):
        assert _read(name, {"trace": {}}) is None


@pytest.mark.cuda
def test_a_kernel_in_a_span_starts_after_the_span_on_the_trace(tmp_path):
    """A matrix product launched inside a program span starts on the card
    after the span's start, on the trace's clock as the readers convert
    the timeline (``spans.base_ns``); the trace's ``baseTimeNanoseconds``
    is the one the readers assume. Prints each span's start against its
    profiler range's and its kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import trace

    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.stretch"):
            for _ in range(5):
                with trace.span("probe"):
                    x @ x
                time.sleep(0.002)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json.gz"
    prof.export_chrome_trace(str(path))
    read = harness.read_trace(path)
    timeline = [t for t in trace.snapshot()["timeline"] if t[0] == "probe"]
    assert len(timeline) == 5
    base = spans.base_ns(read, timeline[0][1])
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    ranges = sorted(float(e["ts"]) for e in data["traceEvents"]
                    if e.get("name") == "mvster.probe" and e.get("cat") == "user_annotation")
    gemms = sorted(a for _, a, _ in read["kernels"])
    print(json.dumps({"baseTimeNanoseconds": data.get("baseTimeNanoseconds"),
                      "ranges": len(ranges), "kernels": len(gemms)}))
    assert int(data.get("baseTimeNanoseconds", 0)) == base
    assert len(ranges) == 5 and len(gemms) >= 5
    rows = []
    for (_, start, _), r in zip(timeline, ranges):
        s = (start - base) * 1e-9
        kernel = min([g for g in gemms if g >= r * 1e-6], default=float("nan"))
        rows.append((s, r * 1e-6, kernel))
    print(json.dumps({"base_ns": base, "span_clock_us": [
        {"range_after_span": (r - s) * 1e6, "kernel_after_span": (k - s) * 1e6}
        for s, r, k in rows]}))
    assert all(s <= r <= k for s, r, k in rows), rows
