"""Profiling of the train step on ``torch.profiler`` and the card's clocks.

Counterpart of the JAX package's ``train/profiler.py`` (the reference's
``--mode profile`` is unimplemented, train_mvs4.py:605-606):

- ``profile_trace``: a context manager that records the host and, on a
  card, the device, and writes a Chrome trace into the logdir;
- ``device_memory_stats``: the caching allocator's bytes in use and peak,
  and the card's memory, per CUDA device (``torch.cuda.memory_stats``);
- ``profile_step_fn``: the first call of a step against the steady state,
  timed on the host clock around work that ends in
  ``torch.cuda.synchronize`` on a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(logdir: str, device: torch.device):
    """Profile the block (CPU activity, and CUDA on a card) and write the
    Chrome trace to ``{logdir}/trace.json``; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        _sync(device)
    prof.export_chrome_trace(path)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device: bytes in use, peak bytes in use (since the last
    ``reset_peak_memory_stats``) and the card's total memory; empty without
    CUDA."""
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": float(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def profile_step_fn(step_fn: Callable[[], Any], device: torch.device, *,
                    iters: int = 10) -> Dict[str, float]:
    """Time ``step_fn``: its first call (the kernels' build and load, the
    allocator's growth and, for a captured step on the card, its warm-up
    and capture included), one warm-up call, then ``iters``
    calls, each group ending in a synchronize of ``device``."""
    t0 = time.perf_counter()
    step_fn()
    _sync(device)
    first = time.perf_counter() - t0
    step_fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn()
    _sync(device)
    per_iter = (time.perf_counter() - t0) / iters
    return {
        "first_call_s": first,
        "steady_state_s": per_iter,
        "steps_per_s": 1.0 / per_iter if per_iter > 0 else float("inf"),
    }
