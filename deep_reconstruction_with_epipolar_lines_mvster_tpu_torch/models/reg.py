"""Cost-volume regularization U-Net ``Reg2D`` (reference reg2d,
``mvs4net_utils.py:884-926``), on folded ``[B*D, H, W, C]`` volumes.

Counterpart of the JAX package's ``models/reg.py`` ``Reg2D`` with
``agg_type="ConvBnReLU3D"``: (1,3,3) stride and boundary convs as 2-D convs
on the folded batch, full 3x3x3 mid blocks after each downsample. In eval
``conv0`` (G -> 8 channels, (1,3,3), stride 1) runs as kernel K6 with the
BatchNorm folded (``models/layers.py``).
"""

from __future__ import annotations

from torch import nn

from .layers import ConvBnReLU3D, ConvWeight, DeconvBnReLU3D, conv2d_nhwc

K133 = (1, 3, 3)
S122 = (1, 2, 2)


class Reg2D(nn.Module):
    """Emits one score per hypothesis, ``[B*D, H, W]``."""

    def __init__(self, in_channels: int, base_channels: int = 8, depth: int = 1):
        super().__init__()
        b = base_channels
        self.conv0 = ConvBnReLU3D(in_channels, b, K133)
        self.conv1 = ConvBnReLU3D(b, 2 * b, K133, S122)
        self.conv2 = ConvBnReLU3D(2 * b, 2 * b, depth=depth)
        self.conv3 = ConvBnReLU3D(2 * b, 4 * b, K133, S122)
        self.conv4 = ConvBnReLU3D(4 * b, 4 * b, depth=depth)
        self.conv5 = ConvBnReLU3D(4 * b, 8 * b, K133, S122)
        self.conv6 = ConvBnReLU3D(8 * b, 8 * b, depth=depth)
        self.conv7 = DeconvBnReLU3D(8 * b, 4 * b)
        self.conv9 = DeconvBnReLU3D(4 * b, 2 * b)
        self.conv11 = DeconvBnReLU3D(2 * b, b)
        self.prob = ConvWeight((1, b, 1, 1, 1), bias=True)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        score = conv2d_nhwc(x, self.prob.weight[:, :, 0], self.prob.bias)
        return score[..., 0]
