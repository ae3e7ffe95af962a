"""Building blocks, NHWC activations; ``train()``/``eval()`` choose the
BatchNorm branch.

Counterpart of the JAX package's ``models/layers.py``. Activations are NHWC
tensors as in the JAX package; each convolution hands ``F.conv2d`` an NCHW
view of them (channels-last strides, no copy). Parameters keep the
reference torch layouts and names (``conv.weight``, ``bn.running_mean``,
...), so the reference's ``state_dict`` loads as it is, and are cast to the
activations' dtype at use, as flax casts them.

Cost volumes flow folded, ``[B*D, H, W, C]``: the (1,3,3) Conv3d kernels are
2-D convolutions over the folded batch, and only the 3x3x3 blocks unfold to
``[B, C, D, H, W]``.

In eval, a 3x3 (or (1,3,3)) stride-1 conv + BatchNorm + ReLU with at most
``BAND_CONV_MAX_CHANNELS[dtype]`` input and output channels runs as kernel
K6 (``ops/kernels/band_conv.py``) with the BatchNorm folded into a scale and
a bias; every other block, and every block in training, is the convolution
library's conv followed by ``TorchBatchNorm`` and ReLU. The route follows
the module's shape, mode and the activations' dtype only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.band_conv import band_conv

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax momentum; torch's 0.1

# The widest eval 3x3 stride-1 conv + BatchNorm + ReLU that runs as K6, per
# activation dtype: where K6 beats the unfused route (cuDNN conv,
# TorchBatchNorm in eval, ReLU) at every layer of the flagship forward up to
# that width (chip_smoke.py's band_conv kernel_shapes rows, which time both
# at each layer's shape and dtype in one call).
BAND_CONV_MAX_CHANNELS = {torch.bfloat16: 64, torch.float32: 32}


class ConvWeight(nn.Module):
    """Parameter holder with a conv's ``weight`` (and optional ``bias``) in
    the reference torch layout; the blocks apply it themselves."""

    def __init__(self, shape, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(shape[0])) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal weights with std 1/sqrt(fan-in), zero bias."""
        fan_in = math.prod(self.weight.shape[1:])
        self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


def conv2d_nhwc(x, weight, bias=None, stride=1, padding=0):
    """2-D convolution of an NHWC tensor with an OIHW weight, in the
    dtype of ``x``."""
    dt = x.dtype
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(dt),
        None if bias is None else bias.to(dt), stride, padding,
    )
    return y.permute(0, 2, 3, 1)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis, in float32 and cast back, with the
    torch ``_BatchNorm`` train semantics of the JAX package's
    ``TorchBatchNorm``. Buffers and parameters are named as in
    ``nn.BatchNorm*d``.

    - eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``;
    - train: batch statistics per contiguous view group of the folded batch
      (fold index ``b*V + v``, so the group axis is the inner one of
      ``reshape(N // G, G, ...)``), normalized with the biased variance; the
      running statistics take the G sequential momentum updates of the
      reference's per-view calls in closed form,
      ``m^G r + (1-m) sum_v m^(G-1-v) s_v`` with flax momentum ``m = 0.9``
      and the unbiased variance."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, groups: int = 1):
        xf = x.float()
        if not self.training:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return (y * self.weight + self.bias).to(x.dtype)
        G = groups
        N, C = x.shape[0], x.shape[-1]
        if N % G:
            raise ValueError(f"batch {N} not divisible by view groups {G}")
        xg = xf.reshape(N // G, G, -1, C)
        var, mean = torch.var_mean(xg, dim=(0, 2), correction=0, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        with torch.no_grad():
            n = xg.shape[0] * xg.shape[2]
            m = BN_MOMENTUM
            w = m ** torch.arange(G - 1, -1, -1, dtype=torch.float32, device=x.device)
            var_unb = var.reshape(G, C) * (n / max(n - 1, 1))
            self.running_mean.mul_(m ** G).add_((1 - m) * (w[:, None] * mean.reshape(G, C)).sum(0))
            self.running_var.mul_(m ** G).add_((1 - m) * (w[:, None] * var_unb).sum(0))
            self.num_batches_tracked.add_(G)
        return (y * self.weight + self.bias).to(x.dtype)

    def folded(self):
        """The eval transform as ``(scale, bias)``, float32 ``[C]``:
        ``scale = weight * rsqrt(running_var + eps)``, ``bias = bias -
        running_mean * scale``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


def band_conv_route(ci: int, co: int, dtype) -> bool:
    """Whether an eval 3x3 stride-1 conv + BatchNorm + ReLU of ``ci`` input
    and ``co`` output channels in ``dtype`` runs as K6."""
    return max(ci, co) <= BAND_CONV_MAX_CHANNELS.get(dtype, 0)


def _band_conv_route(module, weight, dtype) -> bool:
    """Whether an eval-mode block with this OIHW ``weight`` (stride 1) on
    activations of ``dtype`` runs as K6: a 3x3 kernel on its route."""
    return (not module.training and tuple(weight.shape[2:]) == (3, 3)
            and band_conv_route(weight.shape[1], weight.shape[0], dtype))


class ConvBnReLU(nn.Module):
    """2-D conv (no bias) + BatchNorm + ReLU, symmetric ``k//2`` padding
    (not XLA's SAME, which pads asymmetrically at stride 2). ``view_groups``:
    train-mode BatchNorm statistics per view of the view-folded batch."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = ConvWeight((cout, cin, kernel, kernel))
        self.bn = TorchBatchNorm(cout)
        self.stride = stride

    def forward(self, x, view_groups: int = 1):
        if self.stride == 1 and _band_conv_route(self, self.conv.weight, x.dtype):
            return band_conv(x.contiguous(), self.conv.weight, *self.bn.folded())
        x = conv2d_nhwc(x, self.conv.weight, stride=self.stride,
                        padding=self.conv.weight.shape[-1] // 2)
        return F.relu(self.bn(x, view_groups))


class ConvBnReLU3D(nn.Module):
    """Cost-volume conv + BatchNorm + ReLU on folded ``[B*D, H, W, C]``.

    ``kernel``/``stride`` are (depth, height, width). A (1,k,k) kernel runs
    as a 2-D conv on the folded batch; a kernel with depth extent unfolds by
    the static ``depth`` and runs as ``Conv3d``. Padding is ``k//2`` on
    every axis."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 depth: int = 1):
        super().__init__()
        self.conv = ConvWeight((cout, cin, *kernel))
        self.bn = TorchBatchNorm(cout)
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.depth = depth

    def forward(self, x):
        kd, kh, kw = self.kernel
        sd, sh, sw = self.stride
        w = self.conv.weight
        if kd == 1 and self.stride == (1, 1, 1) and _band_conv_route(self, w[:, :, 0], x.dtype):
            return band_conv(x.contiguous(), w[:, :, 0], *self.bn.folded())
        if kd == 1 and sd == 1:
            x = conv2d_nhwc(x, w[:, :, 0], stride=(sh, sw), padding=(kh // 2, kw // 2))
        else:
            N, H, W, C = x.shape
            x5 = x.reshape(N // self.depth, self.depth, H, W, C).permute(0, 4, 1, 2, 3)
            y = F.conv3d(x5, w.to(x.dtype), None, self.stride,
                         (kd // 2, kh // 2, kw // 2))
            B, Co, Do, Ho, Wo = y.shape
            x = y.permute(0, 2, 3, 4, 1).reshape(B * Do, Ho, Wo, Co)
        return F.relu(self.bn(x))


class DeconvBnReLU3D(nn.Module):
    """(1,3,3) stride-(1,2,2) transposed conv + BatchNorm + ReLU on the
    folded batch: an exact x2 spatial upsample, ``ConvTranspose(k=3, s=2,
    p=1, output_padding=1)``. Children ``0`` and ``1`` carry the reference's
    ``Sequential`` key names."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.add_module("0", ConvWeight((cin, cout, 1, 3, 3)))
        self.add_module("1", TorchBatchNorm(cout))

    def forward(self, x):
        w = self._modules["0"].weight[:, :, 0].to(x.dtype)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, 2, 1, 1)
        return F.relu(self._modules["1"](y.permute(0, 2, 3, 1)))
