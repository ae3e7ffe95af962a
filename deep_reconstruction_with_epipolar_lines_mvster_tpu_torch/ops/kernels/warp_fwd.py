"""K4: the plain plane-sweep bilinear warp forward (``csrc/warp_fwd.cu``).

``warp_fwd`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``warp_fwd_ref`` only for a tensor on the CPU. It has no
backward of its own: autograd reaches it only through
``ops/warp.py:WarpIK``, whose backward is K3.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.geometry import grid_sample_2d, warp_coords
from .. import _build

_LAUNCH = _build.Kernel("warp_fwd", "warp_fwd_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8)
_PLAN = _build.Entry("warp_fwd", "warp_fwd_plan", [ctypes.c_int] * 7 + [ctypes.c_void_p])

# Kernel against plain version, relative to max(1, max|plain|): in float32
# the coordinates, taps, weights and the order of the four products are the
# same operations (as K1's, whose float32 results measured within 2.4e-7 of
# its plain version on the card: PyTorch's own kernels may round one
# coordinate an ulp apart); in bf16 both round one float32 result, which may
# then land one bf16 ulp (2^-7 relative at most) apart.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

# the channel counts with a compile-time instance (the stages of FPN base
# 8); any other C takes the generic instance (csrc/warp_fwd.cu)
FAST_CHANNELS = (8, 16, 32, 64)


def warp_fwd_ref(src, rel_proj, hypo) -> torch.Tensor:
    """Plain PyTorch version: bilinear warp of ``src [B,Hs,Ws,C]`` at the
    plane-sweep coordinates of ``(rel_proj [B,4,4], hypo [B,D,H,W])``, zeros
    padding, float32 arithmetic; ``[B,D,H,W,C]`` in the dtype of ``src``."""
    return grid_sample_2d(src.float(), warp_coords(rel_proj, hypo)).to(src.dtype)


def plan(B: int, D: int, H: int, W: int, C: int, Hs: int | None = None,
         Ws: int | None = None) -> str:
    """The launch shape the kernel takes for ``[B, D, H, W, C]`` (a source
    of ``Hs x Ws``, by default ``H x W``), as a ``kernel_shapes`` row's
    ``instance``: the compile-time (``fast``) or generic instance, the lanes
    a pixel and channels a lane, the CTA's threads along x by rows, and the
    planes a CTA walks (``csrc/warp_fwd.cu:warp_fwd_plan``). Loads the
    kernel's library."""
    p = (ctypes.c_int * 6)()
    if _PLAN.status(B, D, H, W, Hs or H, Ws or W, C, ctypes.addressof(p)):
        raise ValueError(f"warp_fwd: shape {(B, D, H, W, C)} exceeds the grid's limits")
    return (f"{'fast' if p[0] else 'generic'} lanes {p[1]}x{p[2]} cta {p[3]}x{p[4]} "
            f"planes {p[5]}/{D}")


def warp_fwd(src, rel_proj, hypo) -> torch.Tensor:
    """``(src [B,Hs,Ws,C] f32/bf16, rel_proj [B,4,4] f32, hypo [B,D,H,W]
    f32) -> [B,D,H,W,C]`` in the dtype of ``src``, any C, float32 arithmetic. Same
    function as JAX ``grid_sample_2d(src, warp_coords(rel, hypo))`` and, where
    their bands cover the taps, as the banded Pallas warps
    ``warp_tiles_pallas_v3`` (no ``ref``), ``warp_tiles_pallas_xband`` and
    ``warp_tiles_pallas``."""
    if src.device.type == "cpu":
        return warp_fwd_ref(src, rel_proj, hypo)
    if src.device.type != "cuda":
        raise ValueError(f"warp_fwd: unsupported device {src.device}")
    _build.refuse_autograd("warp_fwd", src, rel_proj, hypo)
    B, Hs, Ws, C = src.shape
    _, D, H, W = hypo.shape
    for name, t in (("src", src), ("rel_proj", rel_proj), ("hypo", hypo)):
        if t.device != src.device:
            raise ValueError(f"warp_fwd: {name} on {t.device}, src on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"warp_fwd: {name} is not contiguous")
    if src.dtype not in _build.DTYPES:
        raise ValueError(f"warp_fwd: dtype {src.dtype} not supported")
    if rel_proj.dtype != torch.float32 or hypo.dtype != torch.float32:
        raise ValueError("warp_fwd: rel_proj and hypo must be float32")
    if tuple(rel_proj.shape) != (B, 4, 4) or hypo.shape[0] != B:
        raise ValueError(
            f"warp_fwd: shapes src {tuple(src.shape)} rel {tuple(rel_proj.shape)} "
            f"hypo {tuple(hypo.shape)}"
        )
    if min(B, C, D, Hs, Ws) < 1:
        raise ValueError(f"warp_fwd: C={C}, shape {tuple(src.shape)} not supported")
    if src.data_ptr() % 16:
        raise ValueError("warp_fwd: src must be 16-byte aligned")
    out = torch.empty((B, D, H, W, C), dtype=src.dtype, device=src.device)
    _LAUNCH.launch(src.device, src, rel_proj, hypo, out, B, D, H, W, Hs, Ws, C,
                   int(src.dtype == torch.bfloat16))
    return out
