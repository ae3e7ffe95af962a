"""What every driver of the benchmark shares: finding the files of a cell
by name, the seeded weights, host spans, the profiled stretch and its
reading, the device and memory readings, and the isolation check.

Nothing here imports the measured program; the drivers do, inside their
``run`` functions.
"""

from __future__ import annotations

import contextlib
import gzip
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
PROGRAM = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
# top-level module names that may not be loaded in a run: JAX, its
# companions, and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "deep_reconstruction_with_epipolar_lines_mvster_tpu")
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, suffix: str = ".json") -> Path:
    """``benchmark/<kind>/<name><suffix>``; raises when there is none."""
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_module(path: Path):
    """A Python file of the benchmark loaded by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is in ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for the draws of ``stream`` under ``seed``."""
    return np.random.default_rng([seed & (2 ** 63 - 1), stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, stream)``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_rng(seed, stream).integers(0, 2 ** 62)))
    return g


def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Seeded weights for a state dict of ``{name: (shape, dtype)}``, made
    on ``device`` in two draws: convolution and linear weights normal with
    std ``fan_in ** -0.5``; biases ``0.05 N``; BatchNorm scale ``1 + 0.1 N``,
    shift ``0.05 N``, running mean ``0.05 N`` and running variance
    ``U(0.5, 1.5)``; integer buffers zero."""
    gen = device_generator(seed, 1, device)
    floats = [(k, s) for k, (s, dt) in shapes.items() if dt.is_floating_point]
    total = sum(int(np.prod(s)) for _, s in floats)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, i = {}, 0
    for k, s in floats:
        n = int(np.prod(s))
        z, u = normal[i:i + n].reshape(s), uniform[i:i + n].reshape(s)
        i += n
        leaf = k.rsplit(".", 1)[-1]
        bn = any(f"{k.rsplit('.', 1)[0]}.{b}" in shapes for b in ("running_mean",))
        if leaf == "running_var":
            out[k] = 0.5 + u
        elif leaf == "running_mean":
            out[k] = 0.05 * z
        elif bn and leaf == "weight":
            out[k] = 1.0 + 0.1 * z
        elif leaf == "bias":
            out[k] = 0.05 * z
        else:
            fan_in = int(np.prod(s[1:])) if len(s) > 1 else 1
            out[k] = z * fan_in ** -0.5
    for k, (s, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(s, dtype=dt, device=device)
    return out


class Spans:
    """Host spans of the benchmark's own calls into the program: the time
    of each named span, summed per name, over the whole window. Inside a
    profiled stretch each span is also a ``record_function`` range
    (``bench.<name>``) on the trace."""

    def __init__(self):
        self.total = defaultdict(float)
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = torch.profiler.record_function(f"bench.{name}") if self.annotate \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_stretch(step: Callable[[], None], iters: int, spans: Spans, device) -> Dict:
    """Run ``step`` ``iters`` times under ``torch.profiler`` (CPU and CUDA
    activities), the stretch ending in a synchronise. Returns the pending
    profile, which ``finish_trace`` reads once the window has closed, so
    that writing and reading the trace stay out of the window; without a
    card, nothing."""
    if torch.device(device).type != "cuda":
        for _ in range(iters):
            step()
        return {}
    from torch.profiler import ProfilerActivity, profile, record_function

    spans.annotate = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.stretch"):
                for _ in range(iters):
                    step()
                torch.cuda.synchronize(device)
    finally:
        spans.annotate = False
    return {"prof": prof, "iters": iters}


def finish_trace(pending: Dict) -> Dict:
    """The ``read_trace`` reading of a pending profile, with its ``iters``."""
    if not pending:
        return {}
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / "trace.json.gz"
    pending["prof"].export_chrome_trace(str(path))
    try:
        out = read_trace(path)
    finally:
        path.unlink(missing_ok=True)
    out["iters"] = pending["iters"]
    return out


def read_trace(path: Path) -> Dict:
    """From a Chrome trace: ``kernels`` ``[(name, start_s, dur_s)]`` of the
    device work inside the ``bench.stretch`` range, ``window_s`` that
    range's length, ``busy_s`` the union of the device intervals in it,
    ``gaps`` the idle time between them summed by the innermost host span
    open at each gap's middle."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("name") == "bench.stretch"
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return {}
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                 if e.get("cat") in DEVICE_EVENTS)
    dev = [(max(a, t0), min(b, t1), n) for a, b, n in dev if b > t0 and a < t1]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len("bench."):])
            for e in xs if str(e.get("name", "")).startswith("bench.")
            and e["name"] != "bench.stretch" and e.get("cat") == "user_annotation"]
    merged: List[List[float]] = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = defaultdict(float)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        open_ = [h for h in host if h[0] <= mid <= h[1]]
        name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "outside the spans"
        gaps[name] += (b - a) * 1e-6
    return {"kernels": [(n, a * 1e-6, (b - a) * 1e-6) for a, b, n in dev],
            "window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6, "gaps": dict(gaps)}


def breakdown(trace: Dict) -> Optional[Dict]:
    """The result line's ``breakdown``: the ten device operations that took
    most time in the profiled stretch, and the idle time by host span."""
    if not trace:
        return None
    ops = defaultdict(float)
    for name, _, dur in trace["kernels"]:
        ops[name] += dur
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def device_info(device, count: int = 1) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


class Window:
    """The measured window: ``open()`` starts the host clock, ``done()``
    says whether ``seconds`` have passed, ``close()`` synchronises the
    device and returns the window's length."""

    def __init__(self, seconds: float, device):
        self.seconds = seconds
        self.device = device
        self.t0 = None

    def open(self) -> None:
        self.t0 = time.perf_counter()

    def done(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def close(self) -> float:
        sync(self.device)
        return time.perf_counter() - self.t0

