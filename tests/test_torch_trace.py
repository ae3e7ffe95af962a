"""The port's span and counter recorder (``utils/trace.py``) on the CPU:
its aggregates, its profiler ranges and timeline on the trace's clock, and
the spans that the instrumented paths record once a call."""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import TrainConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.loader import DataLoader
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    SyntheticTrainDataset,
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
    make_eval_forward,
    run_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.fusion import FusionConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.scene_filter import fuse_view
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import loop
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import trace


def _sleep_span(name, seconds):
    with trace.span(name):
        time.sleep(seconds)


# ------------------------------------------------------------ the recorder --

def test_nesting_parent_ids_and_self_time():
    """A child span's time leaves its parent's self time, the parent being
    the span open on the thread when the child opened; under a profiler
    the timeline holds each span inside its parent."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer") as outer:
            _sleep_span("inner", 0.02)
            _sleep_span("inner", 0.02)
            time.sleep(0.01)
    snap = trace.snapshot()
    o, i = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (o["count"], i["count"]) == (1, 2)
    assert o["total_s"] == pytest.approx(outer.seconds)
    assert o["self_s"] == pytest.approx(o["total_s"] - i["total_s"])
    assert i["self_s"] == i["total_s"] >= 0.04
    assert 0.01 <= o["self_s"] < o["total_s"] - 0.04 + 0.01
    spans = {name: [] for name in ("outer", "inner")}
    for name, start, end in snap["timeline"]:
        assert start < end
        spans[name].append((start, end))
    assert len(spans["outer"]) == 1 and len(spans["inner"]) == 2
    (s, e), = spans["outer"]
    assert all(s <= a < b <= e for a, b in spans["inner"])


def test_the_ring_keeps_the_recent_durations_and_their_median():
    trace.reset()
    seconds = []
    for ms in (1, 3, 2):
        with trace.span("a") as a:
            time.sleep(ms * 1e-3)
        seconds.append(a.seconds)
    s = trace.snapshot()["spans"]["a"]
    assert s["recent_s"] == pytest.approx(seconds)
    assert statistics.median(s["recent_s"]) == pytest.approx(sorted(seconds)[1])


def test_counters_and_reset():
    trace.reset()
    trace.count("bytes", 5)
    trace.count("bytes", 7)
    trace.count("calls")
    with trace.span("a"):
        pass
    snap = trace.snapshot()
    assert snap["counters"] == {"bytes": 12, "calls": 1}
    assert snap["spans"]["a"]["count"] == 1
    trace.reset()
    snap = trace.snapshot()
    assert snap["counters"] == {} and snap["spans"] == {} and snap["timeline"] == []


def test_memory_is_bounded(monkeypatch):
    """The ring keeps the last ``RING`` durations, whatever the count; the
    timeline keeps ``TIMELINE`` spans and counts the rest as dropped."""
    trace.reset()
    n = 2 * trace.RING + 100
    seconds = []
    for _ in range(n):
        with trace.span("a") as a:
            pass
        seconds.append(a.seconds)
    s = trace.snapshot()["spans"]["a"]
    assert s["count"] == n and s["recent_s"] == pytest.approx(seconds[-trace.RING:])
    assert s["total_s"] == pytest.approx(sum(seconds)) and s["self_s"] == s["total_s"]
    monkeypatch.setattr(trace, "TIMELINE", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(10):
            with trace.span("b"):
                pass
    snap = trace.snapshot()
    assert len(snap["timeline"]) == 4 and snap["dropped"] == 6


def test_spans_of_a_thread_that_ended_are_kept():
    """Each thread keeps its own aggregates; an ended thread's are folded
    into the recorder's when the next thread registers, the ring still
    bounded."""
    import threading

    trace.reset()
    with trace.span("a") as last:
        time.sleep(0.002)

    def work():
        for _ in range(trace.RING + 10):
            with trace.span("a"):
                pass

    ended = []
    for target in (work, lambda: _sleep_span("b", 0)):
        t = threading.Thread(target=target)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        ended.append(t)
    registered = [thread for thread, _ in trace._threads]
    assert ended[0] not in registered and ended[1] in registered
    s = trace.snapshot()["spans"]["a"]
    assert s["count"] == trace.RING + 11 and len(s["recent_s"]) == trace.RING
    assert s["recent_s"][-1] == pytest.approx(last.seconds)


class _Counting:
    """Stands in for ``torch.profiler.record_function``, counting uses."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        pass


def test_no_profiler_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    trace.reset()
    for _ in range(5):
        with trace.span("a"):
            pass
    assert _Counting.entered == 0 and trace.snapshot()["timeline"] == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            pass
    assert _Counting.entered == 1 and len(trace.snapshot()["timeline"]) == 1


def test_profiler_ranges_lie_inside_their_spans(tmp_path):
    """Each exported ``mvster.*`` range, its ``ts`` plus the trace's
    ``baseTimeNanoseconds``, lies inside its span on the timeline."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(10):
            with trace.span("outer"):
                with trace.span("inner"):
                    torch.ones(256, 256).sum()
                torch.ones(64).mul(k)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    got = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(trace.PREFIX):
            start = base + round(float(e["ts"]) * 1e3)
            got.setdefault(e["name"][len(trace.PREFIX):], []).append(
                (start, start + round(float(e["dur"]) * 1e3)))
    want = {}
    for name, start, end in trace.snapshot()["timeline"]:
        want.setdefault(name, []).append((start, end))
    assert sorted(got) == sorted(want) == ["inner", "outer"]
    for name in want:
        assert len(got[name]) == len(want[name]) == 10
        for (a, b), (s, e) in zip(sorted(got[name]), sorted(want[name])):
            assert s <= a < b <= e, (name, s, a, b, e)


# ----------------------------------------------- the instrumented paths --

def _counts():
    return {k: v["count"] for k, v in trace.snapshot()["spans"].items()}


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


@pytest.fixture
def _two_threads():
    # many small CPU operators: OpenMP barriers stall under the parallel run
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_run_forward_records_its_spans_once_a_call(_two_threads):
    scene = make_plane_scene(V=3, H=64, W=64, seed=1)
    batch = batch_samples([scene])
    model = checks.small_step_model(3)
    forward = make_eval_forward(model)
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out, seconds, _ = run_forward(forward, batch, "cpu")
    assert _delta(before, _counts()) == {
        "forward": 1, "forward.copy_in": 1, "forward.wait": 1, "forward.copy_out": 1}
    assert out["depth"].shape == (1, 64, 64)
    timeline = {name: (start, end) for name, start, end in trace.snapshot()["timeline"][-4:]}
    start, end = timeline["forward"]
    assert seconds * 1e9 <= end - start
    for child in ("forward.copy_in", "forward.wait", "forward.copy_out"):
        assert start <= timeline[child][0] < timeline[child][1] <= end


def test_fuse_view_records_its_spans_once_a_call():
    scene = make_plane_scene(V=3, H=32, W=48, seed=2)
    depths = {v: scene["view_depths"][v] for v in range(3)}
    confs = {v: np.ones((32, 48), np.float32) for v in range(3)}
    cams = {v: (scene["intrinsics"], scene["extrinsics"][v]) for v in range(3)}
    images = {v: scene["imgs"][v] for v in range(3)}
    before = _counts()
    out = fuse_view(0, [1, 2], depths, confs, cams, images, FusionConfig(), device="cpu")
    assert _delta(before, _counts()) == {
        "fusion.view": 1, "fusion.filter": 1, "fusion.upload": 1, "fusion.download": 1,
        "fusion.gather": 1}
    assert len(out["xyz"]) == int(out["final_mask"].sum()) > 0


def test_batch_to_torch_records_the_feed_and_its_bytes():
    ds = SyntheticTrainDataset("synthetic://64x64/2", None, "train", 3)
    batch = batch_samples([ds[0], ds[1]])

    def nbytes(tree):
        return sum(nbytes(v) for v in tree.values()) if isinstance(tree, dict) \
            else np.asarray(tree).nbytes

    before, moved = _counts(), trace.snapshot()["counters"].get("feed.bytes", 0)
    batch_to_torch(batch, "cpu")
    assert _delta(before, _counts()) == {"feed": 1}
    assert trace.snapshot()["counters"]["feed.bytes"] - moved == nbytes(batch) > 0


def test_fit_records_the_data_wait_and_step_spans(tmp_path, _two_threads):
    """Each train record's ``step_s`` and ``data_s`` are the durations of
    its ``fit.step`` and ``data.wait`` spans."""
    ds = SyntheticTrainDataset("synthetic://64x64/2", None, "train", 3)
    tcfg = TrainConfig(epochs=1, lr=1e-3, lr_milestones=(10,), summary_freq=1, save_freq=5)
    before = _counts()
    loop.fit(checks.small_step_model(3), DataLoader(ds, 1, num_workers=0), None, tcfg,
             checks.RECIPE_LOSS, logdir=str(tmp_path), device="cpu")
    assert _delta(before, _counts()) == {"data.wait": 3, "fit.step": 2, "feed": 2}
    with open(tmp_path / "metrics.jsonl") as f:
        records = [r for r in map(json.loads, f) if r["mode"] == "train"]
    spans = trace.snapshot()["spans"]
    assert [r["step_s"] for r in records] == spans["fit.step"]["recent_s"][-2:]
    assert [r["data_s"] for r in records] == spans["data.wait"]["recent_s"][-3:-1]
