"""Eval throughput of the port: depth maps per second at the pinned shape.

Counterpart of the JAX repo's ``bench.py``: the flagship DTU-recipe model
(``graft_entry.dtu_model``: bf16, group correlation (8,8,4,4), inverse
depth, attn_temp 2, mono; seeded random weights) at B=4, V=4, 512x640 on
plane scenes (``graft_entry.example_batch``), run as the eval CLI runs it
(``graft_entry.eval_fn``: ``eval.depthgen.make_eval_forward``, under
``inference_mode``).

Method (as the JAX bench's, ``bench.py:59-132``). A dispatch chains CHAIN
forwards, each fed ``imgs + carry * 1e-12`` where ``carry`` is the previous
forward's stage-4 depth mean, a tensor on the device: each forward depends
on the last, as in the JAX ``lax.scan``. On the card the dispatch is one
CUDA graph (``utils/graphs.capture`` of the CHAIN forwards and the carry's
mean, the carry its static 0-d input), the counterpart of JAX's
``jax.jit(lax.scan)``; the first dispatch captures it. Four warm-up
dispatches, then
GROUPS groups of ROUNDS dispatches; each group ends with one ``float(carry)``,
the only host sync, and its rate is B x CHAIN x ROUNDS maps over its host
time. The metric is the median group rate; ``spread_maps_per_s`` is the
largest minus the smallest.

``vs_baseline`` is 1.0: the JAX repo's ``BENCH_r*.json`` hold TPU numbers,
which are no baseline for the card, and the port has no recorded run of
its own yet. Nothing here reads them.

Lines printed: a ``bench`` line with ms per forward, peak device memory
(allocated, and reserved: the graph's memory pool) and the forward's H100
roofline at this shape (``tools/roofline.py``: the bound, ``mfu`` =
logical FLOPs over seconds per forward x the dtype's dense peak,
``bound_share`` = bound ms over measured ms); then the last line,
``{"metric", "value", "unit", "vs_baseline", "spread_maps_per_s",
"groups_maps_per_s", "device"}``, ``device`` the card's name and power
limit from ``nvidia-smi``.

It runs on the card, and without CUDA it raises; ``--device cpu`` runs
the plain versions on the CPU (no device metric).

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.bench [--B 4 --V 4 --H 512 --W 640 --chain 5 --rounds 10 --groups 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .config import setup_device
from .graft_entry import dtu_model, eval_fn, example_batch
from .tools.roofline import mfu, roofline
from .utils import graphs

METRIC = "depth_maps_per_s_512x640_v4"
B, V, H, W = 4, 4, 512, 640
CHAIN, ROUNDS, GROUPS, WARMUP = 5, 10, 3, 4


def card_name() -> str:
    """``name, power.limit`` of card 0 from ``nvidia-smi``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="eval throughput of the port (depth maps/s)")
    for name, default in (("B", B), ("V", V), ("H", H), ("W", W), ("chain", CHAIN),
                          ("rounds", ROUNDS), ("groups", GROUPS)):
        p.add_argument(f"--{name}", type=int, default=default)
    p.add_argument("--device", default=None, help="cpu: the plain versions on the CPU")
    a = p.parse_args(argv)
    dev = setup_device(a.device)
    model = dtu_model(dev)
    batch = example_batch(B=a.B, V=a.V, H=a.H, W=a.W, device=dev)
    fn = eval_fn(model)
    imgs, projs, dv = batch["imgs"], batch["proj_matrices"], batch["depth_values"]

    def chain(carry):
        for _ in range(a.chain):
            carry = fn(imgs + carry * 1e-12, projs, dv)[0].mean().to(imgs.dtype)
        return carry

    dispatch = graphs.capture(chain, "bench chain")

    def zero():
        return torch.zeros((), dtype=imgs.dtype, device=dev)

    with torch.inference_mode():
        c = zero()
        for _ in range(WARMUP):
            c = dispatch(c)
        float(c)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(a.groups):
            c = zero()
            t0 = time.perf_counter()
            for _ in range(a.rounds):
                c = dispatch(c)
            float(c)                                   # the group's one host sync
            rates.append(a.B * a.chain * a.rounds / (time.perf_counter() - t0))
    rates.sort()
    median = rates[len(rates) // 2]
    ms = a.B / median * 1e3
    roof = roofline(model.cfg, a.B, a.V, a.H, a.W)
    card = dev.type == "cuda"
    device = card_name() if card else "cpu"
    # the H100 bound at this shape; mfu and bound_share only from a card's time
    print(json.dumps({"bench": {
        "B": a.B, "V": a.V, "H": a.H, "W": a.W, "dtype": model.cfg.dtype, "chain": a.chain,
        "rounds": a.rounds, "groups": a.groups, "ms_per_forward": ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if card else None,
        # a graph's pool is reserved, not allocated, between its replays
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9 if card else None,
        "h100_bound_ms": roof["bound_ms"], "h100_bytes_ms": roof["bytes_ms"],
        "h100_ops_ms": roof["ops_ms"], "logical_gflop": roof["flops"] / 1e9,
        "min_bytes_gb": roof["bytes"] / 1e9, "mfu": mfu(roof, ms / 1e3) if card else None,
        "bound_share": roof["bound_ms"] / ms if card else None, "device": device}}),
        flush=True)
    line = {"metric": METRIC, "value": median, "unit": "maps/s", "vs_baseline": 1.0,
            "spread_maps_per_s": rates[-1] - rates[0], "groups_maps_per_s": rates,
            "device": device}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
