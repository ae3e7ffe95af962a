"""On the card: each cell's control, the plain reference at the precision
below its configuration's (``tf32`` for float32, ``fp8`` for bf16) put in
the program's place at the cell's own size, fails at least one of the
cell's limits on three seeds (``PERF.md`` §6).

    python3 -m pytest --noconftest -q -m cuda benchmark/tests/test_bench_controls.py
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    config = harness.load_json(harness.find("configs", entry["config"]))
    traffic = harness.load_json(harness.find("traffic", entry["traffic"]))
    spec = harness.load_json(harness.find("workloads", cell))
    driver = harness.load_module(harness.find("drivers", spec["driver"], ".py"))
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = SimpleNamespace(name=cell, seed=seed, seconds=1.0, trace=False, device="cuda",
                              tiny=False, config=config, traffic=traffic, spec=spec,
                              t_start=time.perf_counter())
        numbers = driver.control(ctx, config["control"])
        failed = [k for k, limit in spec["limits"].items() if numbers[k] > limit]
        assert failed, (seed, numbers, spec["limits"])
        gc.collect()
        torch.cuda.empty_cache()
