"""The work of MVSTER's patchify ConvNeXt stem (``reference/mvster_convnext.py``:
the three ``convnext4_block``s) in one eval forward: FLOPs, minimal bytes
and the bound, at ``roofline.py``'s peaks, whatever implements the blocks;
and the FPN4 stem stages those blocks take the place of.

Block ``i`` (``dim = b, 2b, 4b``, ``b`` the FPN base) writes ``P = N h w``
pixels of ``2 dim`` channels at ``1 / 2^i`` of the image, ``N = B V``:

- the patchify conv, 2x2 stride 2, ``dim -> 2 dim``: ``2 P 4 dim 2 dim``;
- the 7x7 conv with two channels a group: ``2 P 49 2 (2 dim)``;
- the pointwise MLP, ``2 dim -> 4 dim -> 2 dim``: ``2 P 2 (2 dim)(4 dim)``;

all convolutions, at the dtype's dense peak as ``roofline.py`` counts
every convolution (``FlopCounterMode`` counts exactly these). On CUDA
cores: the LayerNorm, 8 FLOPs an element (mean, the variance's
difference, square and sum, then subtract, divide, scale, shift), the
layer scale and the residual add, 2 an element, over ``2 dim`` channels,
and the GELU, 8 an element, over ``4 dim``.

Minimal bytes: ``conv0``'s output read once, each block's output written
once and read once by the next (the last block's read is the top-down
pathway's, counted there), in the configuration's dtype, and the weights
once. The bound is ``roofline.py``'s: the larger of bytes over HBM
bandwidth and the tensor FLOPs over the dtype's dense peak plus the rest
over float32's.
"""

from __future__ import annotations

from typing import Dict, List

from . import roofline

LN_FLOPS = 8
SCALE_ADD_FLOPS = 2
GELU_FLOPS = 8


def blocks(B: int, V: int, H: int, W: int, base: int, dtype: str) -> List[Dict]:
    """One piece a block (``roofline`` piece keys, with ``pixels``)."""
    esz = roofline.DTYPE_BYTES[dtype]
    N = B * V
    out = []
    for i, dim in enumerate((base, 2 * base, 4 * base), start=1):
        c2, c4 = 2 * dim, 4 * dim
        px = N * (H >> i) * (W >> i)
        weights = 4 * dim * c2 + 49 * 2 * c2 + 2 * c2 * c4 + 5 * c2 + c4
        written = px * c2 * (1 if i == 3 else 2)
        read_in = N * H * W * base if i == 1 else 0          # conv0's output
        out.append({"name": f"convnext block {i}",
                    "conv_flops": 2.0 * px * (4 * dim * c2 + 49 * 2 * c2 + 2 * c2 * c4),
                    "other_flops": float(px * (c2 * (LN_FLOPS + SCALE_ADD_FLOPS)
                                               + c4 * GELU_FLOPS)),
                    "bytes": float(esz * (read_in + written + weights)),
                    "pixels": px})
    return roofline._bound(out, dtype)


def totals(pieces: List[Dict]) -> Dict[str, float]:
    """The three blocks summed: ``roofline.totals`` and ``pixels``."""
    t = roofline.totals(pieces)
    t["pixels"] = sum(p["pixels"] for p in pieces)
    return t


def fpn4_stages_flops(cfg: Dict, B: int, V: int, H: int, W: int) -> float:
    """FLOPs of FPN4's stem stages ``conv1``-``conv3`` (a 5x5 stride-2 conv
    and two 3x3 convs each) as ``roofline.pieces`` counts them in its "FPN
    stem": the work the ConvNeXt blocks replace."""
    esz = roofline.DTYPE_BYTES[cfg["dtype"]]
    return sum(f for f, _ in roofline._stem(cfg, B * V, H, W, esz)[2:])
