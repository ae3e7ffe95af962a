"""K5: the cross-view attention accumulation of the eval forward
(``csrc/attn_fuse.cu``).

``attn_fuse`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``attn_fuse_ref`` only for a tensor on the CPU. It has no
backward, as the JAX kernel has no VJP: the train path keeps the
autograd-tracked PyTorch attention (``ops/warp_cor.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

_LAUNCH = _build.Kernel("attn_fuse", "attn_fuse_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + [ctypes.c_float] * 2 + [ctypes.c_int])
_PLAN = _build.Entry("attn_fuse", "attn_fuse_plan", [ctypes.c_int] * 5 + [ctypes.c_void_p])

# Kernel against plain version, relative to max(1, max|plain|): the same
# float32 operations in the same order, except the group sum (the plain
# version's reduction may pair its terms differently) and the exponential
# (CUDA's expf against PyTorch's), each a few float32 ulps that the
# normalised weights carry into the output; in bf16 both round one float32
# result, which may then land one bf16 ulp (2^-7 relative at most) apart.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@functools.lru_cache(maxsize=None)
def _plan(B: int, D: int, HW: int, G: int, is_bf16: int) -> tuple:
    """``csrc/attn_fuse.cu:attn_fuse_plan`` for a shape: (on the register
    kernel, G instance, pixels a lane, lanes a pixel group, CTAs)."""
    p = (ctypes.c_longlong * 5)()
    _PLAN.status(B, D, HW, G, is_bf16, ctypes.addressof(p))
    return tuple(p)


def plan(B: int, D: int, H: int, W: int, G: int, dtype) -> str:
    """The launch shape of a call on ``[S,B,D,H,W,G]`` in ``dtype``, as a
    ``kernel_shapes`` row's ``instance``, as the kernel's library chooses
    it (``csrc/attn_fuse.cu:attn_fuse_plan``): the register kernel's G
    instance (G rounded up to a power of two), the pixels a lane (16-byte
    loads where G fills less and H*W allows), the lanes a pixel group (D
    rounded up to a power of two) and its CTAs; or the workspace kernel
    (D over 32 or G over 16). Loads the kernel's library."""
    reg, gm, px, lanes, ctas = _plan(B, D, H * W, G, int(dtype == torch.bfloat16))
    if not reg:
        return "workspace"
    return (f"register g {gm}{'' if gm == G else f' (G {G})'} px {px} lanes {lanes} "
            f"ctas {ctas}")


def attn_fuse_ref(cors, attn_temp: float, channels: int) -> torch.Tensor:
    """Plain PyTorch version: ``cors [S,B,D,H,W,G]`` (one group-correlation
    volume per source view) -> ``[B,D,H,W,G]`` in their dtype, float32
    arithmetic: per view ``w = softmax_D(sum_G cor / attn_temp) /
    sqrt(channels)``, then ``sum_v w·cor / (1e-8 + sum_v w)``."""
    acc = 0.0
    norm = 1e-8
    for cor in cors:
        cor = cor.float()
        w = torch.softmax(cor.sum(dim=-1) / attn_temp, dim=1) / math.sqrt(channels)
        w = w.unsqueeze(-1)
        acc = acc + w * cor
        norm = norm + w
    return (acc / norm).to(cors.dtype)


def attn_fuse(cors, attn_temp: float, channels: int) -> torch.Tensor:
    """``cors [S,B,D,H,W,G]`` f32/bf16 -> ``[B,D,H,W,G]`` in the same dtype,
    float32 inside, for any D and G. Same function as JAX
    ``attn_fuse_native`` (on its native ``[B,D,T,TR,G,W]`` layout) and as
    the XLA chain of ``epipolar_aggregate(attn_fuse_d=True)``. D up to 32
    and G up to 16 run in registers (a lane per pixel and d); a larger D or
    G through a float32 workspace allocated here where the kernel's plan
    says so (``csrc/attn_fuse.cu``), with the same result."""
    if cors.device.type == "cpu":
        return attn_fuse_ref(cors, attn_temp, channels)
    if cors.device.type != "cuda":
        raise ValueError(f"attn_fuse: unsupported device {cors.device}")
    _build.refuse_autograd("attn_fuse", cors)
    if cors.dim() != 6:
        raise ValueError(f"attn_fuse: cors {tuple(cors.shape)} is not [S,B,D,H,W,G]")
    S, B, D, H, W, G = cors.shape
    if not cors.is_contiguous():
        raise ValueError("attn_fuse: cors is not contiguous")
    if cors.dtype not in _build.DTYPES:
        raise ValueError(f"attn_fuse: dtype {cors.dtype} not supported")
    if min(S, B, D, G) < 1 or B >= 2 ** 16:
        raise ValueError(f"attn_fuse: S={S}, B={B}, D={D}, G={G} not supported")
    if H * W >= 2 ** 31 or cors.data_ptr() % 16:
        raise ValueError("attn_fuse: plane too large or cors not 16-byte aligned")
    out = torch.empty((B, D, H, W, G), dtype=cors.dtype, device=cors.device)
    acc = norm = None
    if not _plan(B, D, H * W, G, int(cors.dtype == torch.bfloat16))[0]:
        acc = torch.empty((B, D, H, W, G), dtype=torch.float32, device=cors.device)
        norm = torch.empty((B, D, H, W), dtype=torch.float32, device=cors.device)
    _LAUNCH.launch(cors.device, cors, out, acc, norm, S, B, D, H * W, G, float(attn_temp),
                   math.sqrt(channels), int(cors.dtype == torch.bfloat16))
    return out
