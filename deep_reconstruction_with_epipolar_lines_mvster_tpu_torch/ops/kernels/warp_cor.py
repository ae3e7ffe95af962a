"""K1: fused plane-sweep warp + group correlation (``csrc/warp_cor.cu``).

``warp_cor`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``warp_cor_ref`` only for a tensor on the CPU. It has no
backward: on a CUDA tensor it raises under autograd, and the train path
warps through ``ops/warp.py:WarpIK``.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.geometry import grid_sample_2d, warp_coords
from .. import _build

_LAUNCH = _build.Kernel("warp_cor", "warp_cor_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9)
_PLAN = _build.Entry("warp_cor", "warp_cor_plan", [ctypes.c_int] * 8 + [ctypes.c_void_p])

# Kernel against plain version, relative to max(1, max|plain|): in float32
# the coordinates and taps are the same operations in the same order and
# only the group sum may differ in order; in bf16 both round one float32
# result, which may land one bf16 ulp (2^-7 relative at most) apart.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

# the (C, G) with a compile-time instance (the stages of FPN base 8); any
# other C and G dividing it takes the generic instance (csrc/warp_cor.cu)
FAST_CHANNELS = (8, 16, 32, 64)
FAST_GROUPS = (1, 2, 4, 8)


def group_correlate(wf: torch.Tensor, ref: torch.Tensor, g: int) -> torch.Tensor:
    """``[..., C] x [..., C] -> [..., G]``: per-group channel mean of the
    product."""
    C = wf.shape[-1]
    return (wf * ref).reshape(*wf.shape[:-1], g, C // g).mean(dim=-1)


def warp_cor_ref(src, ref, rel_proj, hypo, groups: int) -> torch.Tensor:
    """Plain PyTorch version: bilinear warp of ``src [B,Hs,Ws,C]`` at the
    plane-sweep coordinates of ``(rel_proj [B,4,4], hypo [B,D,H,W])``, times
    ``ref [B,H,W,C]``, averaged over each of ``groups`` channel groups.
    Float32 arithmetic, result ``[B,D,H,W,G]`` in the dtype of ``src``."""
    warped = grid_sample_2d(src.float(), warp_coords(rel_proj, hypo))
    return group_correlate(warped, ref.float()[:, None], groups).to(src.dtype)


def plan(B: int, D: int, H: int, W: int, C: int, G: int, Hs: int | None = None,
         Ws: int | None = None) -> str:
    """The launch shape the kernel takes for ``[B, D, H, W]`` at ``(C, G)``
    (a source of ``Hs x Ws``, by default ``H x W``), as a ``kernel_shapes``
    row's ``instance``: the compile-time (``fast``) or generic instance, the
    lanes a pixel and channels a lane, the CTA's threads along x by rows,
    and the planes a CTA walks (``csrc/warp_cor.cu:warp_cor_plan``). Loads
    the kernel's library."""
    p = (ctypes.c_int * 6)()
    if _PLAN.status(B, D, H, W, Hs or H, Ws or W, C, G, ctypes.addressof(p)):
        raise ValueError(f"warp_cor: shape {(B, D, H, W, C, G)} exceeds the grid's limits")
    return (f"{'fast' if p[0] else 'generic'} lanes {p[1]}x{p[2]} cta {p[3]}x{p[4]} "
            f"planes {p[5]}/{D}")


def warp_cor(src, ref, rel_proj, hypo, groups: int, out=None) -> torch.Tensor:
    """``(src [B,Hs,Ws,C], ref [B,H,W,C], rel_proj [B,4,4] f32,
    hypo [B,D,H,W] f32, groups) -> [B,D,H,W,G]`` in the dtype of ``src``,
    float32 accumulation. Same function as JAX
    ``correlate_view(impl="gather", group_cor=True)``, for any C and any G
    that divides it. ``out``, a contiguous
    ``[B,D,H,W,G]`` tensor of that dtype (a view's slot of a larger buffer),
    receives the result in place of a new tensor."""
    if src.device.type == "cpu":
        got = warp_cor_ref(src, ref, rel_proj, hypo, groups)
        return got if out is None else out.copy_(got)
    if src.device.type != "cuda":
        raise ValueError(f"warp_cor: unsupported device {src.device}")
    _build.refuse_autograd("warp_cor", src, ref, rel_proj, hypo)
    B, Hs, Ws, C = src.shape
    _, D, H, W = hypo.shape
    for name, t in (("ref", ref), ("rel_proj", rel_proj), ("hypo", hypo)):
        if t.device != src.device:
            raise ValueError(f"warp_cor: {name} on {t.device}, src on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"warp_cor: {name} is not contiguous")
    if not src.is_contiguous():
        raise ValueError("warp_cor: src is not contiguous")
    if src.dtype not in _build.DTYPES or ref.dtype != src.dtype:
        raise ValueError(f"warp_cor: dtypes {src.dtype}/{ref.dtype} not supported")
    if rel_proj.dtype != torch.float32 or hypo.dtype != torch.float32:
        raise ValueError("warp_cor: rel_proj and hypo must be float32")
    if tuple(ref.shape) != (B, H, W, C) or tuple(rel_proj.shape) != (B, 4, 4):
        raise ValueError(
            f"warp_cor: shapes src {tuple(src.shape)} ref {tuple(ref.shape)} "
            f"rel {tuple(rel_proj.shape)} hypo {tuple(hypo.shape)}"
        )
    if min(B, C, D, H, W, Hs, Ws) < 1 or groups < 1 or C % groups:
        raise ValueError(f"warp_cor: C={C}, groups={groups} not supported")
    if src.data_ptr() % 16 or ref.data_ptr() % 16:
        raise ValueError("warp_cor: src and ref must be 16-byte aligned")
    if out is None:
        out = torch.empty((B, D, H, W, groups), dtype=src.dtype, device=src.device)
    elif (tuple(out.shape) != (B, D, H, W, groups) or out.dtype != src.dtype
          or out.device != src.device or not out.is_contiguous()):
        raise ValueError(f"warp_cor: out {tuple(out.shape)} {out.dtype} is not a "
                         f"contiguous [B,D,H,W,G] {src.dtype} tensor on {src.device}")
    _LAUNCH.launch(src.device, src, ref, rel_proj, hypo, out, B, D, H, W, Hs, Ws, C, groups,
                   int(src.dtype == torch.bfloat16))
    return out
