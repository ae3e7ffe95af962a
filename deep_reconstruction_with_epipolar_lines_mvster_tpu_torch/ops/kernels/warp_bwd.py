"""K3: backward of the plane-sweep bilinear warp, dL/dsrc (``csrc/warp_bwd.cu``).

``warp_bwd`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``warp_bwd_ref`` only for a tensor on the CPU. ``launches``
counts the kernel's launches. Autograd reaches it only through
``ops/warp.py:WarpIK``.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.geometry import warp_coords_xy
from .. import _build

launches = 0

# Kernel against plain version, relative to max(1, max|plain|): both take
# the same coordinates, corners and float32 products, bit for bit; only the
# order of the float32 sums differs (the kernel's atomics land in an order
# that changes from run to run). Each source pixel sums at most a few
# hundred terms at the model's shapes, so the difference stays under
# ~3e-5 of the sum of their magnitudes, which is O(max|plain|) for the
# plane-sweep geometry. The same for a bf16 g: it is widened exactly.
TOLERANCE = {torch.float32: 3e-5, torch.bfloat16: 3e-5}

_DTYPES = (torch.float32, torch.bfloat16)
_CHANNELS = (8, 16, 32, 64)


def warp_bwd_ref(g, rel_proj, hypo, src_shape) -> torch.Tensor:
    """Plain PyTorch version: ``g [B,D,H,W,C]`` scattered back through the
    bilinear warp at the plane-sweep coordinates of ``(rel_proj [B,4,4],
    hypo [B,D,H,W])`` onto a zero ``[B,Hs,Ws,C]`` float32 source gradient.
    An explicit ``index_add_`` per corner, not autograd, so that a test
    against ``jax.vjp`` holds an independent derivation."""
    B, Hs, Ws, C = src_shape
    x, y = warp_coords_xy(rel_proj, hypo)
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    # a coordinate beyond int32 (or NaN) is far outside the image: clamp it
    # to a value that is still out of bounds before the integer cast
    x0i = x0.nan_to_num(-2.0).clamp(-2.0, Ws + 1.0).to(torch.int64)
    y0i = y0.nan_to_num(-2.0).clamp(-2.0, Hs + 1.0).to(torch.int64)
    gf = g.reshape(B, -1, C).float()
    base = (torch.arange(B, device=g.device) * (Hs * Ws))[:, None]
    dsrc = torch.zeros((B * Hs * Ws, C), dtype=torch.float32, device=g.device)
    for xi, yi, w in (
        (x0i, y0i, (1.0 - lx) * (1.0 - ly)),
        (x0i + 1, y0i, lx * (1.0 - ly)),
        (x0i, y0i + 1, (1.0 - lx) * ly),
        (x0i + 1, y0i + 1, lx * ly),
    ):
        valid = (xi >= 0) & (xi <= Ws - 1) & (yi >= 0) & (yi <= Hs - 1)
        w = torch.where(valid, w, torch.zeros_like(w))
        idx = base + yi.clamp(0, Hs - 1) * Ws + xi.clamp(0, Ws - 1)
        dsrc.index_add_(0, idx.reshape(-1), (gf * w[..., None]).reshape(-1, C))
    return dsrc.reshape(B, Hs, Ws, C)


def _lib():
    lib = _build.load("warp_bwd")
    fn = lib.warp_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def warp_bwd(g, rel_proj, hypo, src_shape) -> torch.Tensor:
    """``(g [B,D,H,W,C] f32/bf16, rel_proj [B,4,4] f32, hypo [B,D,H,W] f32,
    src_shape (B,Hs,Ws,C)) -> dsrc [B,Hs,Ws,C]`` float32; the caller casts
    it to the source dtype. Same function as the JAX package's
    ``warp_tiles_pallas_xband_bwd_ik`` where its bands cover the taps."""
    if g.device.type == "cpu":
        return warp_bwd_ref(g, rel_proj, hypo, src_shape)
    if g.device.type != "cuda":
        raise ValueError(f"warp_bwd: unsupported device {g.device}")
    _build.refuse_autograd("warp_bwd", g, rel_proj, hypo)
    B, Hs, Ws, C = (int(s) for s in src_shape)
    _, D, H, W = hypo.shape
    for name, t in (("rel_proj", rel_proj), ("hypo", hypo)):
        if t.device != g.device:
            raise ValueError(f"warp_bwd: {name} on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"warp_bwd: {name} is not contiguous")
    if not g.is_contiguous():
        raise ValueError("warp_bwd: g is not contiguous")
    if g.data_ptr() % 16:
        raise ValueError("warp_bwd: g must be 16-byte aligned")
    if g.dtype not in _DTYPES:
        raise ValueError(f"warp_bwd: dtype {g.dtype} not supported")
    if rel_proj.dtype != torch.float32 or hypo.dtype != torch.float32:
        raise ValueError("warp_bwd: rel_proj and hypo must be float32")
    if tuple(g.shape) != (B, D, H, W, C) or tuple(rel_proj.shape) != (B, 4, 4):
        raise ValueError(
            f"warp_bwd: shapes g {tuple(g.shape)} rel {tuple(rel_proj.shape)} "
            f"hypo {tuple(hypo.shape)} src {tuple(src_shape)}"
        )
    if C not in _CHANNELS:
        raise ValueError(f"warp_bwd: C={C} not supported")
    if max(H * W * C, Hs * Ws * C) >= 2 ** 31 or B >= 2 ** 16:
        raise ValueError("warp_bwd: plane or grid too large for the kernel's indices")
    dsrc = torch.zeros((B, Hs, Ws, C), dtype=torch.float32, device=g.device)
    status = _lib()(
        g.data_ptr(), rel_proj.data_ptr(), hypo.data_ptr(), dsrc.data_ptr(),
        B, D, H, W, Hs, Ws, C, int(g.dtype == torch.bfloat16),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(status, "warp_bwd")
    global launches
    launches += 1
    return dsrc
