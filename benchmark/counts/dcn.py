"""The work of MVSTER's four DCN heads (``reference/mvster_dcn.py``) in one
eval forward: FLOPs, minimal bytes and the bound, at ``roofline.py``'s
peaks, whatever implements the heads.

Head ``i`` runs on the pyramid output of ``C = 8b, 4b, 2b, b`` channels
(``b`` the FPN base) at 1/8, 1/4, 1/2 and full resolution, over ``P =
B V h w`` pixels:

- the norm + ReLU: 3 FLOPs an element (scale, shift, max), CUDA cores;
- the offset conv, 3x3 from C to 18 channels: ``2 P 9 C 18``, tensor cores;
- the sampling, nine bilinear taps a pixel: 10 FLOPs a tap for its
  coordinate and corner weights, and 7 a channel (four products, three
  sums), CUDA cores; ``9 P`` samples of a C-vector;
- the contraction of the nine taps, 9C to C: ``2 P 9 C C``, tensor cores.

Minimal bytes: the head's input read once and its output written once, in
the configuration's dtype, and its weights once. The bound is
``roofline.py``'s: the larger of bytes over HBM bandwidth and the tensor
FLOPs over the dtype's dense peak plus the rest over float32's.
"""

from __future__ import annotations

from typing import Dict, List

from . import roofline

OFFSETS = 18


def heads(B: int, V: int, H: int, W: int, base: int, dtype: str) -> List[Dict]:
    """One piece a head (``roofline`` piece keys, with ``samples``)."""
    esz = roofline.DTYPE_BYTES[dtype]
    out = []
    for i, c in enumerate((8 * base, 4 * base, 2 * base, base)):
        px = B * V * (H >> (3 - i)) * (W >> (3 - i))
        weights = 9 * c * c + 9 * c * OFFSETS + OFFSETS + 4 * c
        out.append({"name": f"dcn head {i + 1}",
                    "conv_flops": 2.0 * px * 9 * c * (OFFSETS + c),
                    "other_flops": 3.0 * px * c + 9.0 * px * (10 + 7 * c),
                    "bytes": float(esz * (2 * px * c + weights)),
                    "samples": 9 * px})
    return roofline._bound(out, dtype)


def totals(pieces: List[Dict]) -> Dict[str, float]:
    """The four heads summed: ``roofline.totals`` and ``samples``."""
    t = roofline.totals(pieces)
    t["samples"] = sum(p["samples"] for p in pieces)
    return t
