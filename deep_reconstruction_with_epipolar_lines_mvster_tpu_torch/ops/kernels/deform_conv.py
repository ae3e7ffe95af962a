"""The deformable 3x3 conv of a DCN head after its offset conv, as one pass
(``csrc/deform_conv.cu``): the nine bilinear taps of every pixel at its
offsets and their 9C-to-C contraction (``models/fpn.DeformConv2d``).

The kernel forms each tap's coordinate and corner weights in float32 with
``core.geometry.grid_sample_2d``'s rules, blends the four corners' C-vectors
in float32, rounds each sample once to bf16 and contracts the nine samples
against the weight on the tensor cores (float32 accumulation), writing the
C outputs once in bf16. No ``[N, H, W, 9C]`` tensor and no int64 index is
made; the weight is packed from its float32 parameter at every launch, so a
captured graph reads it as it is at replay. No TPU kernel stood here: the
JAX package's DCN is plain ``jnp``, as :func:`deform_conv_ref` is.

``route`` says where ``DeformConv2d`` takes the kernel: on a CUDA tensor in
bf16 with C in ``CHANNELS``, in eval with no autograd recording (no
backward is written). Everywhere else (training, the CPU, float32, C 4 or 128) it takes
the plain version. ``deform_conv`` launches the kernel on a CUDA tensor and
raises on any it does not take, a CPU tensor included.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.geometry import grid_sample_2d
from .. import _build

_LAUNCH = _build.Kernel("deform_conv", "dcn_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)

DTYPES = (torch.bfloat16,)
# the channel counts the kernel takes (csrc/deform_conv.cu: a tile of
# 2048 / C pixels, the packed [C, 9C] weight in shared memory)
CHANNELS = (8, 16, 32, 64)
TAPS = 9

# Kernel against the plain version computed in float32 with the same bf16
# weight (``limit``): each sample is the plain float32 sample rounded once to
# bf16 (half a bf16 ulp, 2^-8 of it), which reaches the output through
# sum |w| |s|; the output is rounded once (2^-8 of the larger result); and
# the two float32 sums of 9C products, in different orders and the tensor
# cores' accumulation, differ by at most 2 x 9C float32 ulps of sum |w| |s|.
BF16_HALF_ULP = 2.0 ** -8
F32_ULP = 2.0 ** -23


def route(device_type: str, dtype, channels: int, train: bool) -> bool:
    """Whether a deformable conv on a tensor on ``device_type`` of ``dtype``
    with ``channels`` channels runs as the kernel; ``train``: the module is
    in training mode or autograd would record the call."""
    return (device_type == "cuda" and dtype in DTYPES and channels in CHANNELS
            and not train)


def samples(x, off) -> torch.Tensor:
    """The nine taps of every pixel of ``x [N, H, W, C]`` at offsets ``off
    [N, H, W, 18]`` (``(dy, dx)`` of each tap, taps row-major), concatenated
    along the channels: ``[N, H, W, 9C]`` in the dtype of ``x``, each tap
    sampled by ``grid_sample_2d`` at its displaced pixel coordinate
    (differentiable in the coordinates)."""
    N, H, W, C = x.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                            torch.arange(W, dtype=torch.float32, device=x.device),
                            indexing="ij")
    taps = []
    for t in range(TAPS):
        dy, dx = t // 3 - 1, t % 3 - 1
        px = gx + dx + off[..., 2 * t + 1].float()
        py = gy + dy + off[..., 2 * t].float()
        taps.append(grid_sample_2d(x, torch.stack([px, py], dim=-1)))
    return torch.cat(taps, dim=-1)


def deform_conv_ref(x, off, weight) -> torch.Tensor:
    """Plain PyTorch version: ``x [N, H, W, C]``, ``off [N, H, W, 18]``,
    ``weight [O, C, 3, 3]`` -> ``[N, H, W, O]`` in the dtype of ``x``: the
    :func:`samples` contract against the weight cast to the dtype of ``x``."""
    w = weight.permute(2, 3, 1, 0).reshape(TAPS * x.shape[-1], -1)   # rows (ky, kx, i)
    return samples(x, off) @ w.to(x.dtype)


def limit(got, want, x, off, weight) -> torch.Tensor:
    """The largest ``|got - want|`` allowed at each output between the
    kernel (``got``) and :func:`deform_conv_ref` on ``x``, ``off`` and
    ``weight`` computed in float32 with the weight rounded to bf16
    (``want``), float32, shaped as ``want``."""
    C = x.shape[-1]
    w = weight.to(torch.bfloat16).float().permute(2, 3, 1, 0).reshape(TAPS * C, -1)
    terms = samples(x.float(), off.float()).abs() @ w.abs()
    larger = torch.maximum(got.float().abs(), want.float().abs())
    return (BF16_HALF_ULP + 2 * TAPS * C * F32_ULP) * terms + BF16_HALF_ULP * larger


def limit_share(got, x, off, weight) -> float:
    """The largest ``|got - want| / limit`` over the outputs, ``want`` the
    plain version computed in float32 with the weight rounded to bf16 (at
    most 1 for the kernel). An output 0 in both (every tap outside the
    image) has a limit of 0 and counts as 0; a gap that is not finite (a
    NaN or infinite output) counts as infinite."""
    want = deform_conv_ref(x.float(), off.float(), weight.to(torch.bfloat16).float())
    gap = (got.float() - want).abs()
    share = torch.where(gap == 0, 0.0, gap / limit(got, want, x, off, weight))
    return share.nan_to_num(nan=float("inf")).max().item()


def deform_conv(x, off, weight) -> torch.Tensor:
    """``x [N, H, W, C]`` bf16, ``off [N, H, W, 18]`` bf16 and ``weight [C,
    C, 3, 3]`` float32, all contiguous, C in ``CHANNELS`` -> the deformable
    conv ``[N, H, W, C]`` bf16; see :func:`deform_conv_ref` (the kernel
    rounds once a sample and once an output, so it differs from the plain
    bf16 version within a few bf16 ulps). Raises on anything else."""
    _build.refuse_autograd("deform_conv", x, off, weight)
    if x.dim() != 4:
        raise ValueError(f"deform_conv: x {tuple(x.shape)} is not [N, H, W, C]")
    N, H, W, C = x.shape
    if tuple(off.shape) != (N, H, W, 2 * TAPS):
        raise ValueError(f"deform_conv: shapes off {tuple(off.shape)}, x {tuple(x.shape)}")
    if tuple(weight.shape) != (C, C, 3, 3):
        raise ValueError(f"deform_conv: shapes weight {tuple(weight.shape)}, x {tuple(x.shape)}")
    for name, t in (("off", off), ("weight", weight)):
        if t.device != x.device:
            raise ValueError(f"deform_conv: {name} on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES or off.dtype != x.dtype:
        raise ValueError(f"deform_conv: dtype x {x.dtype}, off {off.dtype} not supported")
    if weight.dtype != torch.float32:
        raise ValueError(f"deform_conv: weight must be float32, not {weight.dtype}")
    if C not in CHANNELS:
        raise ValueError(f"deform_conv: C={C} not supported")
    if not (x.is_contiguous() and off.is_contiguous() and weight.is_contiguous()):
        raise ValueError("deform_conv: x, off and weight must be contiguous")
    if x.data_ptr() % 16 or off.data_ptr() % 4:
        raise ValueError("deform_conv: x must be 16-byte and off 4-byte aligned")
    if max(x.numel(), off.numel()) >= 2 ** 31:
        raise ValueError(f"deform_conv: {N * H * W} pixels of {C} channels not supported")
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv: unsupported device {x.device}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        _LAUNCH.launch(x.device, x, off, weight, out, N, H, W, C)
    return out
