"""FPN4 feature pyramid, NHWC (reference ``mvs4net_utils.py:426-509``).

Counterpart of the JAX package's ``models/fpn.py`` ``FPN4`` and
``_TopDown``: stride-2 5x5 stem convs, then a 64-channel top-down pathway.
The three top-down levels (``up2(intra) + inner(skip)``, then the 3x3
``out`` conv) run through kernel K2 (``ops/kernels/topdown.py``), by way of
``ops/topdown_chain.py``: its ``autograd.Function`` in training, K2
directly in eval. The stem and the ``out1`` 1x1 are plain
convolutions; in training the stem's BatchNorm takes statistics per view.
"""

from __future__ import annotations

from torch import nn

from ..ops.topdown_chain import topdown_chain
from .layers import ConvBnReLU, ConvWeight, conv2d_nhwc


class FPN4(nn.Module):
    """4-scale FPN; outputs ``(o1, o2, o3, o4)`` at 1/8, 1/4, 1/2, 1/1
    resolution with 8b, 4b, 2b, b channels. Module names follow the
    reference ``state_dict`` (``feature.conv0.0.conv.weight``, ...)."""

    def __init__(self, base: int = 8):
        super().__init__()
        b = base
        final = 8 * b
        self.conv0 = nn.Sequential(ConvBnReLU(3, b, 3), ConvBnReLU(b, b, 3))
        self.conv1 = nn.Sequential(
            ConvBnReLU(b, 2 * b, 5, 2), ConvBnReLU(2 * b, 2 * b, 3),
            ConvBnReLU(2 * b, 2 * b, 3),
        )
        self.conv2 = nn.Sequential(
            ConvBnReLU(2 * b, 4 * b, 5, 2), ConvBnReLU(4 * b, 4 * b, 3),
            ConvBnReLU(4 * b, 4 * b, 3),
        )
        self.conv3 = nn.Sequential(
            ConvBnReLU(4 * b, 8 * b, 5, 2), ConvBnReLU(8 * b, 8 * b, 3),
            ConvBnReLU(8 * b, 8 * b, 3),
        )
        self.inner1 = ConvWeight((final, 4 * b, 1, 1), bias=True)
        self.inner2 = ConvWeight((final, 2 * b, 1, 1), bias=True)
        self.inner3 = ConvWeight((final, b, 1, 1), bias=True)
        self.out1 = ConvWeight((8 * b, final, 1, 1))
        self.out2 = ConvWeight((4 * b, final, 3, 3))
        self.out3 = ConvWeight((2 * b, final, 3, 3))
        self.out4 = ConvWeight((b, final, 3, 3))

    def forward(self, x, view_groups: int = 1):
        """``x [B*V, H, W, 3]``, views folded ``b*V + v``; ``view_groups=V``
        gives each view its own train-mode BatchNorm statistics."""
        feats = []
        for stem in (self.conv0, self.conv1, self.conv2, self.conv3):
            for block in stem:
                x = block(x, view_groups)
            feats.append(x.contiguous())
        conv0, conv1, conv2, intra = feats
        o1 = conv2d_nhwc(intra, self.out1.weight)
        levels = (
            (conv2, self.inner1, self.out2),
            (conv1, self.inner2, self.out3),
            (conv0, self.inner3, self.out4),
        )
        outs = topdown_chain(
            intra, [skip for skip, _, _ in levels],
            [(inner.weight, inner.bias, out.weight) for _, inner, out in levels],
            train=self.training,
        )
        return (o1, *outs)
