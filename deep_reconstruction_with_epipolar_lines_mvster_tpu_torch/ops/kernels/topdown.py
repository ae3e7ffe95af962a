"""K2: one FPN top-down level (``csrc/topdown.cu``).

``topdown_level`` launches the CUDA kernel on a CUDA tensor and uses the
plain PyTorch version ``topdown_level_ref`` only for a tensor on the CPU.
On a CUDA tensor it raises under autograd: the differentiable chain is
``ops/topdown_chain.py``.
``u_only=True`` returns ``u`` alone (the chain's backward re-derives it):
the kernel skips the 3x3 and the write of ``o``.

Weights come in the PyTorch layouts the port's modules hold: ``wi [Ci, Cs,
1, 1]``, ``bi [Ci]``, ``wo [Co, Ci, 3, 3]``, with Ci = 8 x the FPN base.

Two routes on the card, chosen by shape and dtype: bf16 at the widths of
FPN base 8 (Ci = 64, Cs and Co in {8, 16, 32}) runs on the tensor cores;
every other shape, and every float32 call, runs the generic kernel (any Ci
that is a multiple of 8, any Cs and Co).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...core.geometry import align_corners_taps, resize_align_corners
from .. import _build

_LAUNCH = _build.Kernel("topdown", "topdown_launch", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11)

# Kernel against plain version, relative to max(1, max|plain|): in float32
# the 3x3 sums 576 products in another order than the convolution library
# (~1e-5 relative); in bf16 u and o are each rounded once, and a float32
# difference may flip either rounding by one ulp (2^-7), so two ulps.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}

# the shapes of the bf16 tensor-core route; every other takes the generic kernel
MMA_CI = 64
MMA_CHANNELS = (8, 16, 32)


def topdown_level_ref(intra, skip, wi, bi, wo, with_u: bool = False, u_only: bool = False):
    """Plain PyTorch version. ``intra [N,Hh,Wh,Ci]`` and ``skip [N,H,W,Cs]``
    (NHWC, H = 2·Hh, W = 2·Wh) -> ``o [N,H,W,Co]`` (and ``u [N,H,W,Ci]``
    with ``with_u``; ``u`` alone with ``u_only``), in the dtype of
    ``intra``:

        u = round(up2_align_corners(intra) + Conv1x1(skip; wi) + bi)
        o = Conv3x3(u; wo), zero padding, no bias

    in float32, with the weights and ``u`` rounded to the working dtype
    (as the TPU kernel and the unfused chain round them)."""
    dt = intra.dtype
    H, W = skip.shape[1:3]
    up = resize_align_corners(intra.float(), (H, W))
    skip_nchw = skip.float().permute(0, 3, 1, 2)
    i3 = F.conv2d(skip_nchw, wi.to(dt).float(), bi.float()).permute(0, 2, 3, 1)
    u = (up + i3).to(dt)
    if u_only:
        return u
    o = F.conv2d(u.float().permute(0, 3, 1, 2), wo.to(dt).float(), padding=1)
    o = o.permute(0, 2, 3, 1).to(dt)
    return (o, u) if with_u else o


@functools.lru_cache(maxsize=32)
def _taps(n_out: int, n_in: int, device: torch.device):
    i0, w0, w1 = align_corners_taps(n_out, n_in)
    return (
        torch.as_tensor(i0, dtype=torch.int32, device=device),
        torch.as_tensor(w0, device=device),
        torch.as_tensor(w1, device=device),
    )


def _fragment_kn(K: int, N: int):
    """``(k, n)`` of each element of the B fragments of ``mma.sync
    m16n8k16`` for a ``[K, N]`` operand, in the order the kernel reads them,
    ``[K/16, N/8, 32 lanes, 4]``: lane ``l`` holds ``n = l // 4`` and ``k =
    2t, 2t+1, 2t+8, 2t+9`` (``t = l % 4``) of its 16 x 8 block, the first
    two its register b0, the last two b1."""
    s = np.arange(K // 16)[:, None, None, None]
    j = np.arange(N // 8)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    h = np.arange(4)[None, None, None, :]
    k = 16 * s + 2 * (lane % 4) + h % 2 + 8 * (h // 2)
    n = 8 * j + lane // 4
    return np.broadcast_arrays(k, n)


@functools.lru_cache(maxsize=16)
def _fragment_index(kind: str, C: int, device: torch.device) -> torch.Tensor:
    """Flat indices that gather a weight into the bf16 route's B fragments
    (``torch.take``), Ci = ``MMA_CI``. ``"wo"``: ``wo [Co, 64, 3, 3]`` as 9 taps of ``[K =
    64, N = Co]``, ``[9, 4, Co/8, 32, 4]``. ``"wi"``: ``wi [64, Cs, 1, 1]``
    as ``[K = Cs, N = 64]``, K padded to 16 (a padded k reads k - 8, which
    the kernel multiplies by 0) and N permuted so that column ``8j + 2t +
    e`` is channel ``16t + 2j + e``, ``[max(Cs/16, 1), 8, 32, 4]``."""
    if kind == "wo":
        k, n = _fragment_kn(MMA_CI, C)
        idx = (n * MMA_CI + k)[None] * 9 + np.arange(9)[:, None, None, None, None]
    else:
        k, n = _fragment_kn(max(C, 16), MMA_CI)
        ch = 16 * ((n % 8) // 2) + 2 * (n // 8) + n % 2
        idx = ch * C + np.where(k < C, k, k - 8)
    return torch.as_tensor(np.ascontiguousarray(idx), dtype=torch.int64, device=device)


def topdown_level(intra, skip, wi, bi, wo, with_u: bool = False, u_only: bool = False):
    """One top-down level: ``o`` (and ``u`` with ``with_u``; ``u`` alone
    with ``u_only``); see :func:`topdown_level_ref` for the function."""
    if intra.device.type == "cpu":
        return topdown_level_ref(intra, skip, wi, bi, wo, with_u, u_only)
    if intra.device.type != "cuda":
        raise ValueError(f"topdown_level: unsupported device {intra.device}")
    _build.refuse_autograd("topdown_level", intra, skip, wi, bi, wo)
    N, Hh, Wh, Ci = intra.shape
    _, H, W, Cs = skip.shape
    Co = wo.shape[0]
    for name, t in (("skip", skip), ("wi", wi), ("bi", bi), ("wo", wo)):
        if t.device != intra.device:
            raise ValueError(f"topdown_level: {name} on {t.device}, intra on {intra.device}")
    if not (intra.is_contiguous() and skip.is_contiguous()):
        raise ValueError("topdown_level: intra and skip must be contiguous")
    if intra.dtype not in _build.DTYPES or skip.dtype != intra.dtype:
        raise ValueError(f"topdown_level: dtypes {intra.dtype}/{skip.dtype} not supported")
    if (
        skip.shape[0] != N or (H, W) != (2 * Hh, 2 * Wh)
        or tuple(wi.shape) != (Ci, Cs, 1, 1) or tuple(bi.shape) != (Ci,)
        or tuple(wo.shape) != (Co, Ci, 3, 3)
    ):
        raise ValueError(
            f"topdown_level: shapes intra {tuple(intra.shape)} skip "
            f"{tuple(skip.shape)} wi {tuple(wi.shape)} wo {tuple(wo.shape)}"
        )
    if Ci % 8 or min(N, Hh, Wh, Cs, Co) < 1:
        raise ValueError(f"topdown_level: Ci={Ci} (a multiple of 8), Cs={Cs}, Co={Co} "
                         "not supported")
    if intra.data_ptr() % 16 or skip.data_ptr() % 16:
        raise ValueError("topdown_level: intra and skip must be 16-byte aligned")
    dt = intra.dtype
    mma = dt == torch.bfloat16 and Ci == MMA_CI and Cs in MMA_CHANNELS and Co in MMA_CHANNELS
    ncb = 1 if Co <= 8 else 2 if Co <= 16 else 4
    if mma:
        # the tensor-core route reads B fragments, gathered in one take each
        wi_k = torch.take(wi, _fragment_index("wi", Cs, intra.device)).to(dt)
        wo_k = None if u_only else torch.take(wo, _fragment_index("wo", Co, intra.device)).to(dt)
    else:
        # the generic kernel: float32 weights rounded to the storage dtype,
        # wo as [passes][3][3][Ci][8 ncb], zero past Co
        wi_k = wi[:, :, 0, 0].to(dt).float().t().contiguous()             # [Cs, Ci]
        wo_k = None
        if not u_only:
            cob = 8 * ncb
            passes = -(-Co // cob)
            wpad = F.pad(wo.to(dt).float(), (0, 0, 0, 0, 0, 0, 0, passes * cob - Co))
            wo_k = wpad.reshape(passes, cob, Ci, 3, 3).permute(0, 3, 4, 2, 1).contiguous()
    bi_k = bi.float().contiguous()
    if bi_k.data_ptr() % 16:                # the kernels read it in 16-byte vectors
        bi_k = bi_k.clone()
    hidx, hw0, hw1 = _taps(H, Hh, intra.device)
    widx, ww0, ww1 = _taps(W, Wh, intra.device)
    out = None if u_only else torch.empty((N, H, W, Co), dtype=dt, device=intra.device)
    u = torch.empty((N, H, W, Ci), dtype=dt, device=intra.device) if with_u or u_only else None
    _LAUNCH.launch(intra.device, intra, skip, wi_k, bi_k, wo_k, hidx, hw0, hw1, widx, ww0, ww1,
                   out, u, N, H, W, Hh, Wh, Ci, Cs, Co, int(dt == torch.bfloat16), int(mma), ncb)
    if u_only:
        return u
    return (out, u) if with_u else out
