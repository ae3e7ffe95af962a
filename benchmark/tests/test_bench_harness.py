"""The harness on the CPU at the cells' ``tiny`` sizes: each driver end to
end through ``run.py``, files found by name, the refusals, and ``correct``
coming out false when the timed path is broken underneath."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import faults, harness
from benchmark.counts import classify

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(args, cwd=ROOT, env=None, timeout=300):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_tiny_on_the_cpu(cell, trace):
    out = _run(["--workload", cell, "--seed", str(2 ** 31 + 11), "--seconds", "1",
                "--trace", str(trace), "--cpu-tiny"])
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(line) <= KEYS | {"breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    assert line["attempted"] > 0 and line["failed"] == 0
    names = set(line["checks"])
    assert names == set(harness.load_json(harness.find("workloads", cell))["limits"])
    tail = out.stderr.strip().splitlines()[-len(names) - 1:]
    assert all(t.startswith("check ") for t in tail[:-1]) and tail[-1].startswith("correct:")
    if trace == 0:
        assert "setup_s" in line["metrics"]


def test_without_a_card_the_run_fails_and_prints_nothing():
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout.strip() == ""


def _checkout(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return root


def test_benchmark_files_alone_do_not_run(tmp_path):
    root = _checkout(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0",
                "--cpu-tiny"], cwd=root, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_added_files_are_found_by_name(tmp_path):
    """A new traffic mix, cell, per-layer metric and kernel family are
    files and entries of their own; no existing file changes."""
    root = _checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "benchmark/traffic/dtu_eval_b4v4.json").read_text())
    mix["tiny"]["pool"] = 3
    (root / "benchmark/traffic/dtu_eval_pool3.json").write_text(json.dumps(mix))
    (root / "benchmark/workloads/eval_pool3.json").write_text(
        (root / "benchmark/workloads/eval_dtu_f32.json").read_text())
    (root / "benchmark/metrics/forwards.eval.py").write_text(
        "def read(res):\n    return float(res['iters'])\n")
    (root / "benchmark/kernels/K7.json").write_text(
        json.dumps({"order": 7, "patterns": ["new_kernel"], "pieces": ["K7 "]}))
    bench["workloads"].append({"name": "eval_pool3", "config": "mvster_eval_f32",
                               "traffic": "dtu_eval_pool3", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "forwards.eval", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "eval_maps_per_s", "workloads": ["eval_pool3"]})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_maps_per_s":
            m["workloads"].append("eval_pool3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = _run(["--workload", "eval_pool3", "--seed", "5", "--seconds", "1", "--trace", "1",
                "--cpu-tiny"], cwd=root, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["forwards.eval"]["value"] >= 3
    fams = classify.families(root / "benchmark/kernels")
    assert classify.category("void new_kernel<1>()", fams) == "K7"
    assert all(p.read_bytes() == b for p, b in before.items())


# -- faults planted under the timed path --------------------------------
def _ctx(cell: str, seed: int, dtype: str = "float32"):
    """A cell's context at its tiny sizes, its configuration computed in
    ``dtype``: at these sizes float32 on the CPU agrees with the
    reference to rounding, so a fault is what the check sees. The limits
    are the card's, set for maps of 512x640: at 64x64 one rounding flip
    among the ~16k pixels counted reads 6e-5, so each test first shows its
    seed's sound run correct."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    config = {**harness.load_json(harness.find("configs", entry["config"])), "dtype": dtype}
    mix = harness.load_json(harness.find("traffic", entry["traffic"]))
    spec = harness.load_json(harness.find("workloads", cell))
    return SimpleNamespace(name=cell, seed=seed, seconds=0.5, trace=False, device="cpu",
                           tiny=True, config=config, traffic={**mix, **mix["tiny"]}, spec=spec,
                           t_start=time.perf_counter())


def _driver(cell):
    spec = harness.load_json(harness.find("workloads", cell))
    return harness.load_module(harness.find("drivers", spec["driver"], ".py"))


@pytest.mark.parametrize("cell,fault", [
    ("eval_dtu_bf16", faults.altered_answer), ("eval_dtu_f32", faults.altered_answer),
    ("cloud_bin_f32", faults.altered_answer), ("eval_dtu_f32", faults.scaled_confidence),
    ("cloud_bin_f32", faults.scaled_confidence)])
def test_an_altered_answer_is_not_correct(cell, fault):
    drv = _driver(cell)
    assert drv.run(_ctx(cell, 22))["correct"]
    res = drv.run(_ctx(cell, 22), fault=fault)
    assert not res["correct"], res["checks"]


def test_an_altered_fused_cloud_is_not_correct(monkeypatch):
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval import scene_filter

    fuse_view = scene_filter.fuse_view

    def altered(*args, **kwargs):
        out = fuse_view(*args, **kwargs)
        return {**out, "fused_depth": out["fused_depth"] * 1.01, "xyz": out["xyz"] * 1.01}

    monkeypatch.setattr(scene_filter, "fuse_view", altered)
    res = _driver("cloud_bin_f32").run(_ctx("cloud_bin_f32", 22))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [faults.unchanged_state, faults.half_batch])
def test_a_broken_train_step_is_not_correct(fault):
    drv = _driver("train_dtu_bf16")
    assert drv.run(_ctx("train_dtu_bf16", 22))["correct"]
    res = drv.run(_ctx("train_dtu_bf16", 22), fault=fault)
    assert not res["correct"], res["checks"]
