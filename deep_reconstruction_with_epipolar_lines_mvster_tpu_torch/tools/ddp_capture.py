#!/usr/bin/env python3
"""Which of PyTorch's conditions for capturing a ``DistributedDataParallel``
step into a CUDA graph the port's data-parallel step needs, on one card.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.ddp_capture

Each variant runs in a fresh process, in a world of one rank over NCCL (a
``file://`` store): the small float32 flagship (``checks.small_step_batch``,
B2 V3 64x128) trained through ``parallel.mesh.data_parallel`` in the
``gspmd`` form with a one-rank group (``checks._one_rank_group``, so that
the BatchNorm and loss all-reduces run beside DDP's), its first call
captured (``train.step.TrainStep``), then a second call replayed and one
eager step after it. Variants, each one change from the port:

- ``port``: as the port runs it (DDP built on a side stream,
  ``DDP_WARMUP_STEPS`` eager warm-up steps, the reducer's sampled timing
  off, the capture in CUDA's ``global`` mode);
- ``ddp_on_current_stream``: DDP built on the card's current stream;
- ``warmup_1``, ``warmup_2``, ``warmup_10``: that many warm-up steps;
- ``thread_local``: the capture in ``thread_local`` mode;
- ``nccl_async_error_handling_0``: ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``;
- ``capture_at_100`` and ``sampled_timing_at_100``: 99 warm-up steps, so
  that the capture is the reducer's 100th iteration, with the sampled
  timing off (the port) and on (PyTorch's default: every 100th).

Prints the card's name and power limit, then per variant one JSON line:
whether the first call captured, the error where a call failed, the
replay's loss against the first loss of an eager run from the same seed,
and the NCCL kernels that ``torch.profiler`` sees in one eager step and
in one replay. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch
import torch.distributed as dist

VARIANTS = ("port", "ddp_on_current_stream", "warmup_1", "warmup_2", "warmup_10",
            "thread_local", "nccl_async_error_handling_0", "capture_at_100",
            "sampled_timing_at_100")
VARIANT_TIMEOUT_S = 300


def nccl_kernels(fn) -> int:
    """The NCCL kernels that ``torch.profiler`` sees in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and "nccl" in e.key.lower())


def _patches(variant: str):
    from torch.nn.parallel import DistributedDataParallel

    from ..parallel import mesh
    from ..train import step as step_mod

    stack = contextlib.ExitStack()
    if variant == "ddp_on_current_stream":
        stack.enter_context(mock.patch.object(mesh, "_side_stream",
                                              lambda device: contextlib.nullcontext()))
    if variant.startswith("warmup_"):
        stack.enter_context(mock.patch.object(step_mod, "DDP_WARMUP_STEPS",
                                              int(variant.split("_")[1])))
    if variant.endswith("_at_100"):
        stack.enter_context(mock.patch.object(step_mod, "DDP_WARMUP_STEPS", 99))
    if variant == "sampled_timing_at_100":
        stack.enter_context(mock.patch.object(
            DistributedDataParallel, "_set_ddp_runtime_logging_sample_rate",
            lambda self, rate: None))
    if variant == "thread_local":
        stack.enter_context(mock.patch.object(
            torch.cuda, "graph", functools.partial(torch.cuda.graph,
                                                   capture_error_mode="thread_local")))
    return stack


def run_variant(variant: str) -> dict:
    """One variant (module docstring), in this process."""
    from .. import checks
    from ..config import setup_device
    from ..models import MVS4Net
    from ..parallel.mesh import data_parallel
    from ..train.step import make_optimizer, make_train_step
    from ..utils import graphs

    device = setup_device()
    cfg = checks.small_step_model().cfg
    batch = checks.small_step_batch(device)
    out = {"variant": variant, "captured": False, "error": None}
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        with _patches(variant):
            def dp_step():
                model = MVS4Net(cfg, device=device, generator=torch.Generator().manual_seed(3))
                step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                                       lambda i: 1e-3)
                data_parallel(step, "gspmd", device=device)
                checks._one_rank_group(step)
                return step

            eager = dp_step()
            with graphs.eager():
                out["eager_loss"] = eager(batch)["loss"].item()
                out["nccl_kernels_eager_step"] = nccl_kernels(lambda: eager(batch))
            step = dp_step()
            t0 = time.perf_counter()
            try:
                out["first_call_loss"] = step(batch)["loss"].item()
                out["captured"] = len(step._captured.graphs) == 1
                out["first_call_s"] = time.perf_counter() - t0
                out["nccl_kernels_replay"] = nccl_kernels(lambda: step(batch))
                with graphs.eager():
                    out["eager_step_after_loss"] = step(batch)["loss"].item()
            except Exception as err:                      # the variant's finding
                cause = err.__cause__ or err                  # a CaptureError's cause
                out["error"] = (f"{type(err).__name__} from {type(cause).__name__}: "
                                f"{str(cause).splitlines()[0][:300]}")
            if "first_call_loss" in out:
                out["first_loss_equal"] = out["first_call_loss"] == out["eager_loss"]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", choices=VARIANTS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ddp_capture: needs a CUDA card", file=sys.stderr)
        return 1
    if args.variant:
        print(json.dumps(run_variant(args.variant)), flush=True)
        return 0
    from ..ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    _build.build(_build.KERNELS)
    for variant in VARIANTS:
        env = dict(os.environ)
        if variant == "nccl_async_error_handling_0":
            env["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
        try:
            res = subprocess.run([sys.executable, "-m", __spec__.name, "--variant", variant],
                                 capture_output=True, text=True, env=env,
                                 timeout=VARIANT_TIMEOUT_S)
            lines = [x for x in res.stdout.splitlines() if x.startswith('{"variant"')]
            line = json.loads(lines[-1]) if lines else {
                "variant": variant, "rc": res.returncode,
                "error": (res.stdout + res.stderr)[-1500:]}
        except subprocess.TimeoutExpired:
            line = {"variant": variant, "error": f"timed out after {VARIANT_TIMEOUT_S} s"}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
