"""Cost-volume regularization U-Nets, on folded ``[B*D, H, W, C]`` volumes.

Counterpart of the JAX package's ``models/reg.py``:

- ``Reg2D`` (reference reg2d, ``mvs4net_utils.py:884-926``): (1,3,3) stride
  and boundary convs as 2-D convs on the folded batch, and after each
  downsample a mid block chosen by ``agg_type`` (``models/layers.py``
  ``AGG_BLOCKS``: the full 3x3x3 ``ConvBnReLU3D`` or an attention block).
  In eval ``conv0`` (G -> 8 channels, (1,3,3), stride 1) runs as kernel K6
  with the BatchNorm folded (``models/layers.py``).
- ``Reg3D`` (reference reg3d, ``mvs4net_utils.py:928-979``): a volumetric
  U-Net of 3x3x3 convs (``ConvBnReLU3D``, unfolding by each level's depth),
  halving D, H and W ``down_size`` times (3, 3, 2, 2 per stage: D must
  divide by ``2**down_size``), with 3x3x3 transposed convs back up and a
  3x3x3 score conv. No block of it is on K6's route.

Both emit one score per hypothesis, ``[B*D, H, W]``.
"""

from __future__ import annotations

from torch import nn

from .layers import (
    AGG_BLOCKS,
    ConvBnReLU3D,
    ConvWeight,
    DeconvBnReLU3D,
    DeconvBnReLU3DTrue,
    conv2d_nhwc,
    conv3d_ndhwc,
)

K133 = (1, 3, 3)
S122 = (1, 2, 2)

# reg3d's halvings per stage (reference MVS4Net.py:58)
REG3D_DOWN_SIZE = (3, 3, 2, 2)


class Reg2D(nn.Module):
    """Emits one score per hypothesis, ``[B*D, H, W]``."""

    def __init__(self, in_channels: int, base_channels: int = 8, depth: int = 1,
                 agg_type: str = "ConvBnReLU3D"):
        super().__init__()
        b = base_channels
        mid = AGG_BLOCKS[agg_type]
        self.conv0 = ConvBnReLU3D(in_channels, b, K133)
        self.conv1 = ConvBnReLU3D(b, 2 * b, K133, S122)
        self.conv2 = mid(2 * b, 2 * b, depth=depth)
        self.conv3 = ConvBnReLU3D(2 * b, 4 * b, K133, S122)
        self.conv4 = mid(4 * b, 4 * b, depth=depth)
        self.conv5 = ConvBnReLU3D(4 * b, 8 * b, K133, S122)
        self.conv6 = mid(8 * b, 8 * b, depth=depth)
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


class Reg3D(nn.Module):
    """Emits one score per hypothesis, ``[B*D, H, W]``. Module names follow
    the reference: ``conv0`` .. ``conv{2*down_size}`` (3x3x3 conv +
    BatchNorm + ReLU, the odd ones of stride 2), the transposed convs
    ``conv7`` / ``conv9`` / ``conv11`` of the levels built, ``prob``. The
    volume stays folded; level ``l`` has ``depth >> l`` hypotheses."""

    def __init__(self, in_channels: int, base_channels: int = 8, down_size: int = 3,
                 depth: int = 1):
        super().__init__()
        b = base_channels
        self.depth = depth
        self.down_size = down_size
        widths = [b, 2 * b, 4 * b, 8 * b][: down_size + 1]
        self.conv0 = ConvBnReLU3D(in_channels, b, depth=depth)
        for lvl in range(1, down_size + 1):
            self.add_module(f"conv{2 * lvl - 1}", ConvBnReLU3D(
                widths[lvl - 1], widths[lvl], stride=(2, 2, 2), depth=depth >> (lvl - 1)))
            self.add_module(f"conv{2 * lvl}", ConvBnReLU3D(
                widths[lvl], widths[lvl], depth=depth >> lvl))
        # the up path from the coarsest level: conv7 (8b -> 4b), conv9
        # (4b -> 2b), conv11 (2b -> b), the last down_size of them
        self.up = ["conv7", "conv9", "conv11"][3 - down_size:]
        for name, lvl in zip(self.up, range(down_size, 0, -1)):
            self.add_module(name, DeconvBnReLU3DTrue(widths[lvl], widths[lvl - 1], depth >> lvl))
        self.prob = ConvWeight((1, b, 3, 3, 3))

    def forward(self, x):
        skips = [self.conv0(x)]
        for lvl in range(1, self.down_size + 1):
            down = self._modules[f"conv{2 * lvl - 1}"](skips[-1])
            skips.append(self._modules[f"conv{2 * lvl}"](down))
        y = skips.pop()
        for name in self.up:
            y = skips.pop() + self._modules[name](y)
        N, H, W, C = y.shape
        score = conv3d_ndhwc(y.reshape(N // self.depth, self.depth, H, W, C), self.prob.weight,
                             padding=1)
        return score.reshape(N, H, W)
