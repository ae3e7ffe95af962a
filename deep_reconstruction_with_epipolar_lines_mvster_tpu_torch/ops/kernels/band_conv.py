"""K6: 3x3 stride-1 convolution with a fused scale, bias and ReLU
(``csrc/band_conv.cu``), the eval-mode ``ConvBnReLU`` of the layers on its
route once the BatchNorm is folded (``models/layers.py``).

In bf16 with Ci and Co at most 64 it runs on the tensor cores (an implicit
GEMM on ``mma.sync`` that builds its weight fragments from the float32
weight), wider bf16 layers on the direct form; float32 at any width on the
CUDA cores, register-blocked (a thread's 4 pixels x 2 rows, 1 row where a
launch has few tiles, x 8 output channels) over persistent CTAs that copy
the next unit of (tile, input channels) by TMA while they compute this one. :func:`plan` names the launch shape a call
takes.

``band_conv`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``band_conv_ref`` only for a tensor on the CPU. It has no
backward, as the JAX kernel has no VJP: training keeps the convolution
library and the train-mode BatchNorm.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

_LAUNCH = _build.Kernel("band_conv", "band_conv_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8)
_PLAN = _build.Entry("band_conv", "band_conv_plan", [ctypes.c_int] * 6 + [ctypes.c_void_p])

# Kernel against plain version, relative to max(1, max|plain|): in float32
# the kernel sums the 9·Ci products in another order than the convolution
# library (Ci <= 16 on the path: a few float32 ulps); in bf16 both round one
# float32 result, which may then land one bf16 ulp (2^-7 relative at most)
# apart.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

# the bf16 tensor-core route's widths: Ci padded to one of these, Co to a
# multiple of 8 in 8 x (1, 2, 4, 8); wider bf16 layers take the direct form
MMA_CIP = (8, 16, 32, 64)
MMA_NT = (1, 2, 4, 8)
# the float32 route's copy modes (csrc/band_conv.cu F32Mode)
F32_COPY = ("cp.async", "tma 4d", "tma 3d")


def band_conv_ref(x, weight, scale, bias) -> torch.Tensor:
    """Plain PyTorch version. ``x [N,H,W,Ci]`` (NHWC), ``weight [Co,Ci,3,3]``
    (OIHW), ``scale`` and ``bias [Co]`` -> ``[N,H,W,Co]`` in the dtype of
    ``x``: the 3x3 convolution with zero padding 1 in float32, the weight
    rounded to the dtype of ``x`` (as the TPU kernel rounds its banded
    matrices), then ``max(acc * scale + bias, 0)`` rounded once."""
    dt = x.dtype
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), weight.to(dt).float(), None, 1, 1)
    return torch.relu(acc.permute(0, 2, 3, 1) * scale.float() + bias.float()).to(dt)


def mma_widths(ci: int, co: int):
    """``(cip, nt)`` of the bf16 tensor-core route for ``ci`` input and
    ``co`` output channels, or None where it has no instance (over 64)."""
    cip = next((c for c in MMA_CIP if c >= ci), None)
    nt = next((n for n in MMA_NT if 8 * n >= co), None)
    return None if cip is None or nt is None else (cip, nt)


def plan(N: int, H: int, W: int, Ci: int, Co: int, dtype) -> str:
    """The route and launch shape of a call on ``[N,H,W,Ci] -> Co`` in
    ``dtype`` (x and the weight 16-byte aligned, as PyTorch allocates them),
    as a ``kernel_shapes`` row's ``instance``: the tensor-core widths (Ci
    padded, n-tiles), the bf16 direct form, or, as the kernel's library
    chooses them (``csrc/band_conv.cu:band_conv_plan``), the float32
    route's channel groups, tile, input channels a unit, work items (tile,
    pass), staged units and copy mode. In float32 it loads the kernel's
    library."""
    if dtype == torch.bfloat16:
        widths = mma_widths(Ci, Co)
        return "bf16 direct" if widths is None else "tensor cores cip {} nt {}".format(*widths)
    p = (ctypes.c_int * 5)()
    _PLAN.run(N, H, W, Ci, Co, 1, ctypes.addressof(p))
    cog, rows, cic, items, mode = p
    return (f"float32 cog {cog} tile {rows}x64 ci/unit {cic} items {items} "
            f"units {items * -(-Ci // cic)} copy {F32_COPY[mode]}")


def band_conv(x, weight, scale, bias) -> torch.Tensor:
    """``x [N,H,W,Ci]`` f32/bf16, contiguous; ``weight [Co,Ci,3,3]``,
    ``scale`` and ``bias [Co]``, float32 and contiguous -> ``[N,H,W,Co]`` in
    the dtype of ``x``, for any H, W, Ci and Co. Same function as JAX
    ``band_conv3x3`` on its ``[N,H,Ci,W]`` layout; see
    :func:`band_conv_ref`."""
    if x.device.type == "cpu":
        return band_conv_ref(x, weight, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"band_conv: unsupported device {x.device}")
    _build.refuse_autograd("band_conv", x, weight, scale, bias)
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"band_conv: x {tuple(x.shape)} / weight {tuple(weight.shape)} "
                         "are not [N,H,W,Ci] / [Co,Ci,3,3]")
    N, H, W, Ci = x.shape
    Co = weight.shape[0]
    if tuple(weight.shape) != (Co, Ci, 3, 3) or tuple(scale.shape) != (Co,) \
            or tuple(bias.shape) != (Co,):
        raise ValueError(f"band_conv: shapes x {tuple(x.shape)} weight {tuple(weight.shape)} "
                         f"scale {tuple(scale.shape)} bias {tuple(bias.shape)}")
    for name, t in (("weight", weight), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"band_conv: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"band_conv: {name} must be contiguous float32, not {t.dtype}")
    if x.dtype not in _build.DTYPES:
        raise ValueError(f"band_conv: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("band_conv: x is not contiguous")
    if min(N, H, W, Ci, Co) < 1 or N >= 2 ** 16:
        raise ValueError(f"band_conv: N={N}, H={H}, W={W}, Ci={Ci}, Co={Co} not supported")
    out = torch.empty((N, H, W, Co), dtype=x.dtype, device=x.device)
    widths = mma_widths(Ci, Co) if x.dtype == torch.bfloat16 else None
    if widths is not None and x.data_ptr() % 16:
        raise ValueError("band_conv: x must be 16-byte aligned")
    cip, nt = widths or (0, 0)
    _LAUNCH.launch(x.device, x, weight, scale, bias, out, N, H, W, Ci, Co,
                   int(x.dtype == torch.bfloat16), cip, nt)
    return out
