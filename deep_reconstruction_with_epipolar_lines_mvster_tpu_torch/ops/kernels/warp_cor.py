"""K1: fused plane-sweep warp + group correlation (``csrc/warp_cor.cu``).

``warp_cor`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``warp_cor_ref`` only for a tensor on the CPU. ``launches``
counts the kernel's launches, so a run can show that its main path went
through the kernel. It has no backward: on a CUDA tensor it raises under
autograd, and the train path warps through ``ops/warp.py:WarpIK``.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.geometry import grid_sample_2d, warp_coords
from .. import _build

launches = 0

# Kernel against plain version, relative to max(1, max|plain|): in float32
# the coordinates and taps are the same operations in the same order and
# only the group sum may differ in order; in bf16 both round one float32
# result, which may land one bf16 ulp (2^-7 relative at most) apart.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

_DTYPES = (torch.float32, torch.bfloat16)
_CHANNELS = (8, 16, 32, 64)
_GROUPS = (1, 2, 4, 8)


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


def _lib():
    lib = _build.load("warp_cor")
    fn = lib.warp_cor_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def warp_cor(src, ref, rel_proj, hypo, groups: int) -> torch.Tensor:
    """``(src [B,Hs,Ws,C], ref [B,H,W,C], rel_proj [B,4,4] f32,
    hypo [B,D,H,W] f32, groups) -> [B,D,H,W,G]`` in the dtype of ``src``,
    float32 accumulation. Same function as JAX
    ``correlate_view(impl="gather", group_cor=True)``."""
    if src.device.type == "cpu":
        return warp_cor_ref(src, ref, rel_proj, hypo, groups)
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
    if src.dtype not in _DTYPES or ref.dtype != src.dtype:
        raise ValueError(f"warp_cor: dtypes {src.dtype}/{ref.dtype} not supported")
    if rel_proj.dtype != torch.float32 or hypo.dtype != torch.float32:
        raise ValueError("warp_cor: rel_proj and hypo must be float32")
    if tuple(ref.shape) != (B, H, W, C) or tuple(rel_proj.shape) != (B, 4, 4):
        raise ValueError(
            f"warp_cor: shapes src {tuple(src.shape)} ref {tuple(ref.shape)} "
            f"rel {tuple(rel_proj.shape)} hypo {tuple(hypo.shape)}"
        )
    if C not in _CHANNELS or groups not in _GROUPS or C % groups:
        raise ValueError(f"warp_cor: C={C}, groups={groups} not supported")
    if src.data_ptr() % 16 or ref.data_ptr() % 16:
        raise ValueError("warp_cor: src and ref must be 16-byte aligned")
    out = torch.empty((B, D, H, W, groups), dtype=src.dtype, device=src.device)
    status = _lib()(
        src.data_ptr(), ref.data_ptr(), rel_proj.data_ptr(), hypo.data_ptr(),
        out.data_ptr(), B, D, H, W, Hs, Ws, C, groups,
        int(src.dtype == torch.bfloat16),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(status, "warp_cor")
    global launches
    launches += 1
    return out
