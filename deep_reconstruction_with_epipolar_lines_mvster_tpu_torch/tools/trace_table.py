"""Device time of a ``torch.profiler`` trace by category and by kernel.

Counterpart of the JAX repo's ``_trace_table.py`` (which reads a
``jax.profiler`` trace by XLA's ``hlo_category``). A PyTorch trace names
kernels, not categories, so ``category`` sorts a kernel by its name:

- ``K1`` .. ``K6``: the port's kernels (``<name>_kernel`` symbols of
  ``csrc/*.cu``: ``warp_cor``, ``topdown``, ``warp_bwd``, ``warp_fwd``,
  ``attn_fuse``, ``band_conv``);
- ``conv_library``: cuDNN's and CUTLASS's convolution kernels;
- ``gemm``: the other GEMMs (``gemm``, ``sm90_``, ``cutlass``, ``cublas``);
- ``copies``: memory copies and sets;
- ``elementwise``: PyTorch's elementwise and reduction kernels;
- ``other``.

A kernel takes the first category whose names match, in that order
(``band_conv_kernel`` is K6, not the convolution library). ``chip_smoke.py``
computes its profiles' shares with the same function.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.trace_table TRACE [ITERS] [TOP]

reads a Chrome trace (``export_chrome_trace``; ``.json`` or ``.json.gz``)
of ``ITERS`` iterations and prints device ms per iteration by category and
the ``TOP`` kernels.
"""

from __future__ import annotations

import gzip
import json
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

PORT_KERNELS = {"warp_cor": "K1", "topdown": "K2", "warp_bwd": "K3", "warp_fwd": "K4",
                "attn_fuse": "K5", "band_conv": "K6"}
CONV_LIBRARY = ("conv", "cudnn", "xmma", "implicit", "winograd", "wgrad", "dgrad")
GEMM = ("gemm", "sm90_", "cutlass", "cublas")
COPIES = ("memcpy", "memset")
ELEMENTWISE = ("elementwise", "reduce", "vectorized", "unrolled", "at::native")
CATEGORIES = (*PORT_KERNELS.values(), "conv_library", "gemm", "copies", "elementwise", "other")
# trace event categories of device work in a torch.profiler Chrome trace
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    """The category of a kernel (module docstring)."""
    low = name.lower()
    for kernel, label in PORT_KERNELS.items():
        if f"{kernel}_kernel" in low:
            return label
    for label, subs in (("conv_library", CONV_LIBRARY), ("gemm", GEMM), ("copies", COPIES),
                        ("elementwise", ELEMENTWISE)):
        if any(s in low for s in subs):
            return label
    return "other"


def by_category(kernels: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Sum of ``(name, ms)`` pairs by ``category``, every category present."""
    out = dict.fromkeys(CATEGORIES, 0.0)
    for name, ms in kernels:
        out[category(name)] += ms
    return out


def read_trace(path: str) -> List[Tuple[str, float]]:
    """``(kernel name, ms)`` of every device event of a Chrome trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["dur"]) / 1e3) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENTS and "dur" in e]


def table(path: str, iters: int = 1, top: int = 20) -> Dict[str, object]:
    """Print and return device ms per iteration by category and the ``top``
    kernels (ms per iteration, calls per iteration)."""
    kernels = read_trace(path)
    cats = {k: v / iters for k, v in by_category(kernels).items()}
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, ms in kernels:
        ops[name][0] += ms / iters
        ops[name][1] += 1
    total = sum(cats.values())
    print(f"device total {total:.3f} ms/iter; by category:")
    for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        if ms:
            print(f"    {ms:8.3f}  {ms / total if total else 0:6.1%}  {c}")
    print("top kernels (ms/iter, calls/iter):")
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, calls) in ranked:
        print(f"    {ms:8.3f} {calls / iters:6.1f}  {category(name):12s} {name[:100]}")
    return {"device_ms": total, "by_category": cats,
            "top": [{"kernel": n, "ms": ms, "calls": c / iters} for n, (ms, c) in ranked]}


if __name__ == "__main__":
    table(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 1,
          int(sys.argv[3]) if len(sys.argv) > 3 else 20)
