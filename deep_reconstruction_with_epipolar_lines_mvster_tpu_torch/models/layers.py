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
``[B, C, D, H, W]``. Reg2D's mid blocks are ``ConvBnReLU3D`` or one of the
attention blocks of ``AGG_BLOCKS`` (``agg_type``).

Normalisation takes its statistics in float32 and casts back:
``TorchBatchNorm``; ``GroupNorm`` (``max(1, C // 8)`` groups, eps 1e-5) in
the ``gn`` variant's ``ConvBnReLU``, whose conv then has a bias;
``LayerNorm`` (eps 1e-6) in the ConvNeXt blocks.

In eval, a 3x3 (or (1,3,3)) stride-1 conv + BatchNorm + ReLU with at most
``BAND_CONV_MAX_CHANNELS[dtype]`` input and output channels runs as kernel
K6 (``ops/kernels/band_conv.py``) with the BatchNorm folded into a scale and
a bias; every other block (GroupNorm, no ReLU, wider, strided), and every
block in training, is the convolution library's conv followed by its norm
and ReLU. There, on the card, an eval ``TorchBatchNorm`` and the ReLU after
it are one pass of kernel ``norm_act`` (``ops/kernels/norm_act.py``) over
the activations, made contiguous, and a train-mode one is the kernels of
``ops/kernels/bn_train.py`` with their own backward; the CPU takes their
plain versions. The route follows the module's shape, norm and mode and
the activations' device, dtype and width only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import bn_train as _bn_train
from ..ops.kernels import norm_act as _norm_act
from ..ops.kernels.band_conv import band_conv

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax momentum; torch's 0.1

# The widest eval 3x3 stride-1 conv + BatchNorm + ReLU that runs as K6, per
# activation dtype: where K6 beats the unfused route (cuDNN conv, then
# TorchBatchNorm in eval with its ReLU, one norm_act pass) at every layer of
# the flagship forward up to that width (chip_smoke.py's band_conv
# kernel_shapes rows, which time both at each layer's shape and dtype in one
# call).
BAND_CONV_MAX_CHANNELS = {torch.bfloat16: 64, torch.float32: 32}


class ConvWeight(nn.Module):
    """Parameter holder with a conv's ``weight`` (and optional ``bias``) in
    the reference torch layout; the blocks apply it themselves."""

    def __init__(self, shape, bias: bool = False, zero: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(shape[0])) if bias else None
        self.zero = zero

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal weights with std 1/sqrt(fan-in) (zeros where built with
        ``zero``), zero bias."""
        fan_in = math.prod(self.weight.shape[1:])
        if self.zero:
            self.weight.zero_()
        else:
            self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


def conv2d_nhwc(x, weight, bias=None, stride=1, padding=0, groups=1):
    """2-D convolution of an NHWC tensor with an OIHW weight, in the
    dtype of ``x``."""
    dt = x.dtype
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(dt),
        None if bias is None else bias.to(dt), stride, padding, 1, groups,
    )
    return y.permute(0, 2, 3, 1)


def conv3d_ndhwc(x, weight, bias=None, stride=1, padding=0):
    """3-D convolution of an NDHWC tensor with an OIDHW weight, in the
    dtype of ``x``."""
    dt = x.dtype
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3), weight.to(dt),
        None if bias is None else bias.to(dt), stride, padding,
    )
    return y.permute(0, 2, 3, 4, 1)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis, in float32 and cast back, with the
    torch ``_BatchNorm`` train semantics of the JAX package's
    ``TorchBatchNorm``. Buffers and parameters are named as in
    ``nn.BatchNorm*d``.

    - eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``,
      on the card one ``norm_act`` pass (``eval_norm``);
    - train: batch statistics per contiguous view group of the folded batch
      (fold index ``b*V + v``, so the group axis is the inner one of
      ``reshape(N // G, G, ...)``), normalized with the biased variance; the
      running statistics take the G sequential momentum updates of the
      reference's per-view calls in closed form,
      ``m^G r + (1-m) sum_v m^(G-1-v) s_v`` with flax momentum ``m = 0.9``
      and the unbiased variance. On the card (bf16 or float32, at most
      ``bn_train.MAX_CHANNELS`` channels, no ``sync_group``) the kernels of
      ``ops/kernels/bn_train.py``, forward and backward, over the input
      made contiguous; everywhere else its plain version ``bn_train_ref``.

    ``sync_group`` (set by ``parallel.mesh.data_parallel`` under
    ``dp_impl="gspmd"`` on more than one rank): the train-mode statistics
    are those of the global batch, every rank's samples, as GSPMD computes
    them: the batch sum and then the sum of squared deviations all-reduced
    over the group (differentiable), in float32.

    ``relu``: the ReLU of the output, fused into the same pass in eval and
    on the card in training."""

    sync_group = None

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, groups: int = 1, relu: bool = False):
        if not self.training:
            return self.eval_norm(x, relu)
        args = (self.weight, self.bias, self.running_mean, self.running_var,
                self.num_batches_tracked, groups, self.eps, BN_MOMENTUM, relu)
        if self.sync_group is None and _bn_train.route(x):
            return _bn_train.bn_train(x.contiguous(), *args)
        return _bn_train.bn_train_ref(x, *args, sync_group=self.sync_group)

    def eval_norm(self, x, relu: bool = False):
        """The eval transform (and ReLU): kernel ``norm_act`` on the card
        (its plain version on the CPU); it raises on what it cannot take."""
        return _norm_act.norm_act(x.contiguous(), self.weight, self.bias, self.running_mean,
                                  self.running_var, self.eps, relu)

    def folded(self):
        """The eval transform as ``(scale, bias)``, float32 ``[C]``:
        ``scale = weight * rsqrt(running_var + eps)``, ``bias = bias -
        running_mean * scale``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


class GroupNorm(nn.Module):
    """GroupNorm over the last axis (flax ``nn.GroupNorm``; reference
    ``nn.GroupNorm``): ``groups`` contiguous channel groups, statistics per
    sample and group in float32, biased variance, cast back."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        N, C = x.shape[0], x.shape[-1]
        xg = x.float().reshape(N, -1, self.groups, C // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)


def group_norm(channels: int, group_channel: int = 8) -> GroupNorm:
    """The reference's GroupNorm: ``max(1, channels // group_channel)``
    groups, eps 1e-5."""
    return GroupNorm(channels, max(1, channels // group_channel))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in float32, cast back (the ConvNeXt
    blocks' ``norm``, eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.eps).to(x.dtype)


def linear(x, weight, bias=None):
    """``nn.Linear`` with a ``[O, I]`` weight, in the dtype of ``x``."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def band_conv_route(ci: int, co: int, dtype) -> bool:
    """Whether an eval 3x3 stride-1 conv + BatchNorm + ReLU of ``ci`` input
    and ``co`` output channels in ``dtype`` runs as K6."""
    return max(ci, co) <= BAND_CONV_MAX_CHANNELS.get(dtype, 0)


def _band_conv_route(module, weight, dtype) -> bool:
    """Whether an eval-mode block with this OIHW ``weight`` (stride 1) on
    activations of ``dtype`` runs as K6: a 3x3 kernel on its route, and a
    BatchNorm and ReLU for K6 to fold and fuse."""
    return (not module.training and getattr(module, "relu", True)
            and isinstance(getattr(module, "bn", None), TorchBatchNorm)
            and tuple(weight.shape[2:]) == (3, 3)
            and band_conv_route(weight.shape[1], weight.shape[0], dtype))


class ConvBnReLU(nn.Module):
    """2-D conv + BatchNorm (or, with ``gn``, a biased conv + GroupNorm) +
    ReLU (unless ``relu=False``), symmetric ``k//2`` padding (not XLA's
    SAME, which pads asymmetrically at stride 2). ``view_groups``:
    train-mode BatchNorm statistics per view of the view-folded batch."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, gn: bool = False):
        super().__init__()
        self.conv = ConvWeight((cout, cin, kernel, kernel), bias=gn)
        self.bn = None if gn else TorchBatchNorm(cout)
        self.gn = group_norm(cout) if gn else None
        self.stride = stride
        self.relu = relu

    def on_band_conv(self, dtype) -> bool:
        """Whether the block runs as K6 on activations of ``dtype``."""
        return self.stride == 1 and _band_conv_route(self, self.conv.weight, dtype)

    def forward(self, x, view_groups: int = 1):
        if self.on_band_conv(x.dtype):
            return band_conv(x.contiguous(), self.conv.weight, *self.bn.folded())
        x = conv2d_nhwc(x, self.conv.weight, self.conv.bias, stride=self.stride,
                        padding=self.conv.weight.shape[-1] // 2)
        if self.gn is None:
            return self.bn(x, view_groups, relu=self.relu)
        x = self.gn(x)
        return F.relu(x) if self.relu else x


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

    def on_band_conv(self, dtype) -> bool:
        """Whether the block runs as K6 on activations of ``dtype``."""
        return (self.kernel[0] == 1 and self.stride == (1, 1, 1)
                and _band_conv_route(self, self.conv.weight[:, :, 0], dtype))

    def forward(self, x):
        kd, kh, kw = self.kernel
        sd, sh, sw = self.stride
        w = self.conv.weight
        if self.on_band_conv(x.dtype):
            return band_conv(x.contiguous(), w[:, :, 0], *self.bn.folded())
        if kd == 1 and sd == 1:
            x = conv2d_nhwc(x, w[:, :, 0], stride=(sh, sw), padding=(kh // 2, kw // 2))
        else:
            N, H, W, C = x.shape
            y = conv3d_ndhwc(x.reshape(N // self.depth, self.depth, H, W, C), w,
                             stride=self.stride, padding=(kd // 2, kh // 2, kw // 2))
            x = y.reshape(-1, *y.shape[2:])
        return self.bn(x, relu=True)


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
        return self._modules["1"](y.permute(0, 2, 3, 1), relu=True)


class _AttnConv3D(nn.Module):
    """Residual attention mid block (reference ``ConvBnReLU3D_{CAM,DCAM,
    PAM,PDAM}``, ``mvs4net_utils.py:132-202``; the JAX package's
    ``_AttnConvBase``): ``relu(bn(attn(y) * y + x))`` with ``y`` the 3x3x3
    conv of ``x``, folded ``[B*D, H, W, C]`` in and out, unfolded by the
    static ``depth`` inside. ``attention(y5)`` returns the multiplier."""

    def __init__(self, cin: int, cout: int, depth: int = 1):
        super().__init__()
        self.conv = ConvWeight((cout, cin, 3, 3, 3))
        self.bn = TorchBatchNorm(cout)
        self.depth = depth

    def forward(self, x):
        N, H, W, C = x.shape
        x5 = x.reshape(N // self.depth, self.depth, H, W, C)
        y = conv3d_ndhwc(x5, self.conv.weight, padding=1)
        out = (y * self.attention(y) + x5).reshape(N, H, W, -1)
        return self.bn(out, relu=True)


class _MLP(nn.Module):
    """``Linear(C, C//2), ReLU, Linear(C//2, C)`` with the reference's
    ``linear_agg.0`` / ``linear_agg.2`` key names."""

    def __init__(self, channels: int):
        super().__init__()
        self.add_module("0", ConvWeight((channels // 2, channels), bias=True))
        self.add_module("2", ConvWeight((channels, channels // 2), bias=True))

    def forward(self, x):
        a, b = self._modules["0"], self._modules["2"]
        return linear(F.relu(linear(x, a.weight, a.bias)), b.weight, b.bias)


class ConvBnReLU3D_CAM(_AttnConv3D):
    """Channel attention: the MLP of the mean and max over (D, H, W)."""

    def __init__(self, cin: int, cout: int, depth: int = 1):
        super().__init__(cin, cout, depth)
        self.linear_agg = _MLP(cout)

    def attention(self, y):
        avg = self.linear_agg(y.mean(dim=(1, 2, 3)))
        mx = self.linear_agg(y.amax(dim=(1, 2, 3)))
        return torch.sigmoid(avg + mx)[:, None, None, None, :]


class ConvBnReLU3D_DCAM(_AttnConv3D):
    """Depth-channel attention: the MLP per depth slice, over (H, W)."""

    def __init__(self, cin: int, cout: int, depth: int = 1):
        super().__init__(cin, cout, depth)
        self.linear_agg = _MLP(cout)

    def attention(self, y):
        avg = self.linear_agg(y.mean(dim=(2, 3)))
        mx = self.linear_agg(y.amax(dim=(2, 3)))
        return torch.sigmoid(avg + mx)[:, :, None, None, :]


class ConvBnReLU3D_PAM(_AttnConv3D):
    """Pixel attention: a 7x7 conv of the (max, mean) over depth and
    channels."""

    def __init__(self, cin: int, cout: int, depth: int = 1):
        super().__init__(cin, cout, depth)
        self.pixel_conv = ConvWeight((1, 2, 7, 7), bias=True)

    def attention(self, y):
        desc = torch.stack([y.amax(dim=(1, 4)), y.mean(dim=(1, 4))], dim=-1)
        a = conv2d_nhwc(desc, self.pixel_conv.weight, self.pixel_conv.bias, padding=3)
        return torch.sigmoid(a)[:, None]


class ConvBnReLU3D_PDAM(_AttnConv3D):
    """Pixel-depth attention: a 7x7x7 conv of the (max, mean) over
    channels."""

    def __init__(self, cin: int, cout: int, depth: int = 1):
        super().__init__(cin, cout, depth)
        self.spatial_conv = ConvWeight((1, 2, 7, 7, 7), bias=True)

    def attention(self, y):
        desc = torch.stack([y.amax(dim=4), y.mean(dim=4)], dim=-1)
        a = conv3d_ndhwc(desc, self.spatial_conv.weight, self.spatial_conv.bias, padding=3)
        return torch.sigmoid(a)


# Reg2D's mid blocks by ``agg_type`` (an unknown name raises KeyError, as
# the JAX package's lookup does)
AGG_BLOCKS = {
    "ConvBnReLU3D": ConvBnReLU3D,
    "ConvBnReLU3D_CAM": ConvBnReLU3D_CAM,
    "ConvBnReLU3D_DCAM": ConvBnReLU3D_DCAM,
    "ConvBnReLU3D_PAM": ConvBnReLU3D_PAM,
    "ConvBnReLU3D_PDAM": ConvBnReLU3D_PDAM,
}


class DeconvBnReLU3DTrue(nn.Module):
    """3x3x3 stride-2 transposed conv + BatchNorm + ReLU on the folded
    batch, unfolded by the static ``depth`` (reg3d's up path): an exact x2
    on D, H and W, ``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)``.
    Children ``0`` and ``1`` carry the reference's ``Sequential`` key
    names."""

    def __init__(self, cin: int, cout: int, depth: int = 1):
        super().__init__()
        self.add_module("0", ConvWeight((cin, cout, 3, 3, 3)))
        self.add_module("1", TorchBatchNorm(cout))
        self.depth = depth

    def forward(self, x):
        N, H, W, C = x.shape
        x5 = x.reshape(N // self.depth, self.depth, H, W, C).permute(0, 4, 1, 2, 3)
        y = F.conv_transpose3d(x5, self._modules["0"].weight.to(x.dtype), None, 2, 1, 1)
        y = y.permute(0, 2, 3, 4, 1)
        return self._modules["1"](y.reshape(-1, *y.shape[2:]), relu=True)
