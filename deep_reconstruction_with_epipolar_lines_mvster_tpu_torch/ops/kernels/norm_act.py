"""Eval-mode BatchNorm with an optional ReLU as one pass over activations
whose last axis is the channels (``csrc/norm_act.cu``): the norm of every
eval block that runs the convolution library's conv
(``models/layers.TorchBatchNorm``).

The kernel forms ``scale = weight * rsqrt(running_var + eps)`` and ``shift
= bias - running_mean * scale`` from the BatchNorm's four float32 ``[C]``
tensors at every launch (so a captured graph reads them as they are at its
replay), then writes ``max(x * scale + shift, 0)`` (or no max) in float32,
rounded once to the dtype of ``x``, into a fresh tensor. It moves each
element of ``x`` once in and once out, 16 bytes a thread; no TPU kernel
stood here (XLA fused the affine map into its neighbours).

``norm_act`` launches the CUDA kernel on a CUDA tensor and uses the plain
PyTorch version ``norm_act_ref`` only for a tensor on the CPU. It has no
backward: training keeps the train-mode BatchNorm.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_LAUNCH = _build.Kernel("norm_act", "norm_act_launch", [ctypes.c_void_p] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int])

DTYPES = (torch.float32, torch.bfloat16)
# the widest C the kernel takes (csrc/norm_act.cu MAX_CHANNELS: its table
# of scale and shift in shared memory)
MAX_CHANNELS = 4096


# Kernel against plain version, element by element (``limit``): one ulp of
# the larger result in the dtype of x (2^-7 relative in bf16, where the two
# float32 values fall on either side of a rounding boundary; none in float32)
# plus five float32 ulps of the terms |x * scale| + |mean * scale| + |bias|,
# which may cancel: the kernel folds first, and each form rounds at most five
# times in float32, each by half an ulp of a quantity no larger than them.
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
F32_ULPS = 5 * 2.0 ** -23


def limit(got, want, x, weight, bias, mean, var, eps: float) -> torch.Tensor:
    """The largest ``|got - want|`` allowed at each element between the
    kernel and its plain version (or any other order of the same
    arithmetic), float32, shaped as ``x``."""
    scale = weight * torch.rsqrt(var + eps)
    terms = (x.float() * scale).abs() + (mean * scale).abs() + bias.abs()
    larger = torch.maximum(got.float().abs(), want.float().abs())
    return ULP[x.dtype] * larger + F32_ULPS * terms


def norm_act_ref(x, weight, bias, mean, var, eps: float, relu: bool) -> torch.Tensor:
    """Plain PyTorch version, the eval BatchNorm as the port computed it
    before the kernel: ``(x - mean) * rsqrt(var + eps) * weight + bias`` in
    float32, the ReLU where ``relu``, cast back to the dtype of ``x``."""
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    y = y * weight + bias
    return (torch.relu(y) if relu else y).to(x.dtype)


def norm_act(x, weight, bias, mean, var, eps: float, relu: bool) -> torch.Tensor:
    """``x [..., C]`` float32 or bf16, contiguous; ``weight``, ``bias``,
    ``mean`` and ``var`` float32 ``[C]``, contiguous -> the eval BatchNorm
    of ``x`` (and its ReLU where ``relu``) in the dtype of ``x``; see
    :func:`norm_act_ref` (the kernel folds first, so a float32 result may
    differ from it by a few ulps, and a bf16 one at rounding ties)."""
    if x.device.type == "cpu":
        return norm_act_ref(x, weight, bias, mean, var, eps, relu)
    _build.refuse_autograd("norm_act", x, weight, bias, mean, var)
    if x.dim() < 1:
        raise ValueError("norm_act: x has no channel axis")
    C = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias), ("mean", mean), ("var", var)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"norm_act: {name} {tuple(t.shape)}, x {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError(f"norm_act: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"norm_act: {name} must be contiguous float32, not {t.dtype}")
    if x.dtype not in DTYPES:
        raise ValueError(f"norm_act: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("norm_act: x is not contiguous")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"norm_act: C={C} not supported")
    if x.device.type != "cuda":
        raise ValueError(f"norm_act: unsupported device {x.device}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        _LAUNCH.launch(x.device, x, out, weight, bias, mean, var, x.numel(), C, float(eps),
                       int(bool(relu)), int(x.dtype == torch.bfloat16))
    return out
