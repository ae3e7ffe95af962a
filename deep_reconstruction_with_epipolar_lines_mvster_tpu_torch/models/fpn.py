"""Feature pyramids and ASFF fusion, NHWC.

Counterpart of the JAX package's ``models/fpn.py``:

- ``FPN4`` (reference ``mvs4net_utils.py:426-509``): stride-2 5x5 stem
  convs, then a top-down pathway of 8 x base channels (64 at the flagship's
  base 8);
- ``FPN4ConvNeXt`` (reference ``FPN4_convnext`` / ``FPN4_convnext4``,
  ``:533-728``): a two-conv stem and three ConvNeXt blocks (``ConvNeXtBlock``
  or, with ``patchify``, ``ConvNeXt4Block``, in eval on the card one kernel
  a block, ``ops/kernels/convnext_block.py``) in place of the 5x5 stages,
  then the same top-down pathway;
- with ``dcn``, each output passes a norm + ReLU + deformable conv head
  (``NADCN``, reference ``NA_DCN``, ``:410-424``; ``DeformConv2d`` is DCN
  v1, the JAX package's formulation, in eval on the card one kernel a head,
  ``ops/kernels/deform_conv.py``);
- ``ASFF`` (reference ``:730-812``): per stage, a learned softmax blend of
  all four pyramid levels.

The three top-down levels (``up2(intra) + inner(skip)``, then the 3x3
``out`` conv) run through kernel K2 (``ops/kernels/topdown.py``), by way of
``ops/topdown_chain.py``: its ``autograd.Function`` in training, K2 directly
in eval. In eval the stem's 3x3 stride-1 conv + BatchNorm + ReLU layers on
K6's route (``models/layers.py``: at base 8 every one in bf16, up to
``conv2.2`` in float32; none with GroupNorm) and ASFF's ``expand`` convs on
it run as kernel K6 with the BatchNorm folded; everything else is the
convolution library's. In training every BatchNorm takes statistics per
view (``view_groups``), as the reference's per-view calls do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry import upsample_nearest_2x
from ..ops.kernels import convnext_block, deform_conv
from ..ops.topdown_chain import topdown_chain
from ..utils import trace
from .layers import (
    ConvBnReLU,
    ConvWeight,
    GroupNorm,
    LayerNorm,
    TorchBatchNorm,
    conv2d_nhwc,
    group_norm,
    linear,
)


class DeformConv2d(ConvWeight):
    """Deformable 3x3 conv, stride 1 (DCN v1; the reference's
    ``DeformConvPack``): ``conv_offset``, a 3x3 conv that starts at zero,
    gives each tap a ``(dy, dx)`` displacement (taps row-major); each tap
    is sampled bilinearly at its displaced pixel coordinate, zeros outside
    the image, and the nine samples contract against ``weight [O, I, 3,
    3]``. Where ``deform_conv.route`` takes it (eval with no autograd
    recording, on the card, bf16, C 8, 16, 32 or 64) the sampling and the
    contraction are one kernel (``ops/kernels/deform_conv.py``); elsewhere
    the plain version ``deform_conv_ref`` (``core.geometry.grid_sample_2d``,
    differentiable in the coordinates)."""

    def __init__(self, cin: int, cout: int):
        super().__init__((cout, cin, 3, 3))
        self.conv_offset = ConvWeight((18, cin, 3, 3), bias=True, zero=True)

    def forward(self, x):
        off = conv2d_nhwc(x, self.conv_offset.weight, self.conv_offset.bias, padding=1)
        train = self.training or (torch.is_grad_enabled()
                                  and any(t.requires_grad for t in (x, off, self.weight)))
        if deform_conv.route(x.device.type, x.dtype, x.shape[-1], train):
            return deform_conv.deform_conv(x.contiguous(), off.contiguous(), self.weight)
        return deform_conv.deform_conv_ref(x, off, self.weight)


class NADCN(nn.Module):
    """BatchNorm (or GroupNorm) + ReLU + ``DeformConv2d``; children ``0``
    and ``2`` carry the reference's ``Sequential`` key names.

    Each call is a ``dcn`` span (``utils/trace``: the norm + ReLU, the
    offset conv, the nine taps and the contraction) and adds ``9 N H W``,
    the bilinear samples of a C-vector it takes, to the counter
    ``dcn.samples``. Both are host-side: inside a captured forward
    (``utils/graphs``) they record only while the graph is warmed up and
    recorded, not on replay; eager calls (training, ``graphs.eager()``)
    record every call."""

    def __init__(self, channels: int, gn: bool = False):
        super().__init__()
        self.add_module("0", group_norm(channels) if gn else TorchBatchNorm(channels))
        self.add_module("2", DeformConv2d(channels, channels))

    def forward(self, x, view_groups: int = 1):
        N, H, W, _ = x.shape
        trace.count("dcn.samples", 9 * N * H * W)
        with trace.span("dcn"):
            norm = self._modules["0"]
            if isinstance(norm, GroupNorm):
                return self._modules["2"](F.relu(norm(x)))
            return self._modules["2"](norm(x, view_groups, relu=True))


class _TopDownFPN(nn.Module):
    """The top-down pathway, output heads and optional DCN heads that FPN4
    and the ConvNeXt pyramids share; module names follow the reference
    ``state_dict`` (``feature.inner1.weight``, ``feature.dcn1.2.weight``)."""

    def _build_top_down(self, base: int, gn: bool, dcn: bool) -> None:
        b = base
        final = 8 * b
        self.inner1 = ConvWeight((final, 4 * b, 1, 1), bias=True)
        self.inner2 = ConvWeight((final, 2 * b, 1, 1), bias=True)
        self.inner3 = ConvWeight((final, b, 1, 1), bias=True)
        self.out1 = ConvWeight((8 * b, final, 1, 1))
        self.out2 = ConvWeight((4 * b, final, 3, 3))
        self.out3 = ConvWeight((2 * b, final, 3, 3))
        self.out4 = ConvWeight((b, final, 3, 3))
        self.dcn = dcn
        if dcn:
            for i, ch in enumerate((8 * b, 4 * b, 2 * b, b)):
                self.add_module(f"dcn{i + 1}", NADCN(ch, gn))

    def _top_down(self, conv0, conv1, conv2, intra, view_groups: int):
        o1 = conv2d_nhwc(intra, self.out1.weight)
        levels = (
            (conv2, self.inner1, self.out2),
            (conv1, self.inner2, self.out3),
            (conv0, self.inner3, self.out4),
        )
        outs = (o1, *topdown_chain(
            intra, [skip for skip, _, _ in levels],
            [(inner.weight, inner.bias, out.weight) for _, inner, out in levels],
            train=self.training,
        ))
        if self.dcn:
            outs = tuple(self._modules[f"dcn{i + 1}"](o, view_groups)
                         for i, o in enumerate(outs))
        return outs


class FPN4(_TopDownFPN):
    """4-scale FPN; outputs ``(o1, o2, o3, o4)`` at 1/8, 1/4, 1/2, 1/1
    resolution with 8b, 4b, 2b, b channels. Module names follow the
    reference ``state_dict`` (``feature.conv0.0.conv.weight``, ...)."""

    def __init__(self, base: int = 8, gn: bool = False, dcn: bool = False):
        super().__init__()
        b = base

        def cbr(cin, cout, k, s=1):
            return ConvBnReLU(cin, cout, k, s, gn=gn)

        self.conv0 = nn.Sequential(cbr(3, b, 3), cbr(b, b, 3))
        self.conv1 = nn.Sequential(cbr(b, 2 * b, 5, 2), cbr(2 * b, 2 * b, 3),
                                   cbr(2 * b, 2 * b, 3))
        self.conv2 = nn.Sequential(cbr(2 * b, 4 * b, 5, 2), cbr(4 * b, 4 * b, 3),
                                   cbr(4 * b, 4 * b, 3))
        self.conv3 = nn.Sequential(cbr(4 * b, 8 * b, 5, 2), cbr(8 * b, 8 * b, 3),
                                   cbr(8 * b, 8 * b, 3))
        self._build_top_down(base, gn, dcn)

    def forward(self, x, view_groups: int = 1):
        """``x [B*V, H, W, 3]``, views folded ``b*V + v``; ``view_groups=V``
        gives each view its own train-mode BatchNorm statistics."""
        feats = []
        for stem in (self.conv0, self.conv1, self.conv2, self.conv3):
            for block in stem:
                x = block(x, view_groups)
            feats.append(x.contiguous())
        return self._top_down(*feats, view_groups)


def _convnext_pixels(y):
    """``y [N, h, w, C]``, a ConvNeXt block's output, with ``N h w`` added
    to the counter ``convnext.pixels``."""
    trace.count("convnext.pixels", y.shape[0] * y.shape[1] * y.shape[2])
    return y


class ConvNeXtBlock(nn.Module):
    """Downsampling ConvNeXt block (reference ``convnext_block``): 7x7
    stride-2 conv with ``groups=dim`` (dim -> 2 dim), LayerNorm, pointwise
    MLP with exact GELU, layer scale ``gamma``; no residual.

    Each call of a block of either kind is a ``convnext`` span
    (``utils/trace``: everything from its first conv to its output) and
    adds ``N h w``, the pixels of its output, to the counter
    ``convnext.pixels``. Both record as ``NADCN``'s do: at a captured
    forward's warm-up and recording, not on replay; every eager call."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        d2 = 2 * dim
        self.dim = dim
        self.dwconv = ConvWeight((d2, 1, 7, 7), bias=True)
        self.norm = LayerNorm(d2)
        self.pwconv1 = ConvWeight((4 * dim, d2), bias=True)
        self.pwconv2 = ConvWeight((d2, 4 * dim), bias=True)
        self.gamma = nn.Parameter(torch.full((d2,), layer_scale_init))

    def _mlp(self, x):
        x = F.gelu(linear(self.norm(x), self.pwconv1.weight, self.pwconv1.bias))
        return linear(x, self.pwconv2.weight, self.pwconv2.bias) * self.gamma.to(x.dtype)

    def forward(self, x):
        with trace.span("convnext"):
            x = conv2d_nhwc(x, self.dwconv.weight, self.dwconv.bias, 2, 3, groups=self.dim)
            return _convnext_pixels(self._mlp(x))


class ConvNeXt4Block(ConvNeXtBlock):
    """Patchify ConvNeXt block (reference ``convnext4_block``): a 2x2
    stride-2 conv ``sconv`` (dim -> 2 dim), then the 7x7 conv with
    ``groups=dim`` (two channels in and out per group), LayerNorm, MLP and
    layer scale, added to the ``sconv`` output. Where
    ``convnext_block.route`` takes it (eval with no autograd recording, on
    the card, bf16, dim 8, 16 or 32) the whole block is one kernel
    (``ops/kernels/convnext_block.py``); elsewhere the plain version
    ``convnext_block_ref``."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__(dim, layer_scale_init)
        self.sconv = ConvWeight((2 * dim, dim, 2, 2), bias=True)
        self.dwconv = ConvWeight((2 * dim, 2, 7, 7), bias=True)

    def forward(self, x):
        with trace.span("convnext"):
            params = tuple(self.get_parameter(name) for name in convnext_block.PARAMS)
            train = self.training or (torch.is_grad_enabled()
                                      and any(t.requires_grad for t in (x, *params)))
            if convnext_block.route(x.device.type, x.dtype, self.dim, train):
                y = convnext_block.convnext_block(x.contiguous(), *params, eps=self.norm.eps)
            else:
                y = convnext_block.convnext_block_ref(x, *params, eps=self.norm.eps)
            return _convnext_pixels(y)


class FPN4ConvNeXt(_TopDownFPN):
    """FPN4 with ConvNeXt stages (``patchify`` selects convnext4): the same
    outputs, widths and top-down pathway as ``FPN4``."""

    def __init__(self, base: int = 8, gn: bool = False, dcn: bool = False,
                 patchify: bool = False):
        super().__init__()
        b = base
        block = ConvNeXt4Block if patchify else ConvNeXtBlock
        self.conv0 = nn.Sequential(ConvBnReLU(3, b, 3, gn=gn), ConvBnReLU(b, b, 3, gn=gn))
        self.conv1 = block(b)
        self.conv2 = block(2 * b)
        self.conv3 = block(4 * b)
        self._build_top_down(base, gn, dcn)

    def forward(self, x, view_groups: int = 1):
        for block in self.conv0:
            x = block(x, view_groups)
        conv0 = x.contiguous()
        conv1 = self.conv1(conv0).contiguous()
        conv2 = self.conv2(conv1).contiguous()
        conv3 = self.conv3(conv2).contiguous()
        return self._top_down(conv0, conv1, conv2, conv3, view_groups)


def _max_pool(x, k: int):
    """k x k max pool, stride k, of ``[N, H, W, C]``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def _up_nearest(x, factor: int):
    for _ in range(factor.bit_length() - 1):
        x = upsample_nearest_2x(x)
    return x


class ASFF(nn.Module):
    """Adaptive scale feature fusion into pyramid level ``level`` (0 = the
    coarsest, stage 1) at its width ``inter``: every coarser level through a
    1x1 ``compress_level_j`` and a nearest upsample, every finer one through
    a max pool and a 3x3 stride-2 ``stride_level_j``; per level a 1x1 conv
    + BatchNorm to 8 channels, with no ReLU (the reference passes its
    ``relu`` argument a 0, ``mvs4net_utils.py:757-760``); a 1x1 conv
    ``weight_levels`` to 4 logits, softmax over them in float32, the
    weighted sum, and the 3x3 ``expand`` conv + BatchNorm + ReLU. Takes the
    views folded into the batch: ``view_groups=V`` gives the per-view
    train-mode BatchNorm statistics of the reference's per-view calls."""

    def __init__(self, level: int, base: int = 8):
        super().__init__()
        b = base
        dims = (8 * b, 4 * b, 2 * b, b)
        inter = dims[level]
        self.level = level
        for j, ch in enumerate(dims):
            if j < level:
                self.add_module(f"compress_level_{j}", ConvBnReLU(ch, inter, 1))
            elif j > level:
                self.add_module(f"stride_level_{j}", ConvBnReLU(ch, inter, 3, 2))
        for k in range(4):
            self.add_module(f"weight_level_{k}", ConvBnReLU(inter, 8, 1, relu=False))
        self.weight_levels = ConvWeight((4, 32, 1, 1), bias=True)
        self.expand = ConvBnReLU(inter, inter, 3)

    def forward(self, feats, view_groups: int = 1):
        lvl = self.level
        rs = []
        for j, x in enumerate(feats):
            if j < lvl:
                x = self._modules[f"compress_level_{j}"](x, view_groups)
                x = _up_nearest(x, 1 << (lvl - j))
            elif j > lvl:
                if j - lvl > 1:
                    x = _max_pool(x, 1 << (j - lvl - 1))
                x = self._modules[f"stride_level_{j}"](x, view_groups)
            rs.append(x)
        ws = [self._modules[f"weight_level_{k}"](r, view_groups) for k, r in enumerate(rs)]
        logits = conv2d_nhwc(torch.cat(ws, dim=-1), self.weight_levels.weight,
                             self.weight_levels.bias)
        w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        fused = sum(r * w[..., k:k + 1] for k, r in enumerate(rs))
        return self.expand(fused, view_groups)
