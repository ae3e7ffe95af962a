"""Plain float32 MVSTER with the patchify ConvNeXt pyramid: the eval forward
of ``mvster.Net`` whose pyramid stages 1-3 are the reference repository's
``convnext4_block`` (``FPN4_convnext4``, ``models/mvs4net_utils.py:560-728``,
its ``--arch_mode fpn_convnext4``), after the ConvNeXt block of Liu et al.
(arXiv:2201.03545).

Each of the three blocks, on ``x [N, dim, H, W]``:

- ``inp``, a 2x2 stride-2 "patchify" conv with bias, ``dim -> 2 dim``;
- a 7x7 conv with bias, padding 3, ``groups=dim``: two channels in and out
  a group;
- LayerNorm over the channels of each pixel, eps 1e-6: ``(y - mean) /
  sqrt(var + eps) * weight + bias`` with the biased variance;
- a pointwise MLP ``2 dim -> 4 dim -> 2 dim`` with biases and the exact
  GELU between, ``h (1 + erf(h / sqrt 2)) / 2``;
- the layer scale ``gamma`` (one a channel), then ``inp +`` the scaled
  branch.

``conv0`` (two 3x3 conv + BatchNorm + ReLU) and the top-down pathway are
the flagship's; the top-down pathway is restated here as ``mvster.Net``
writes it. Parameters are read by the reference repository's ``state_dict``
names: ``feature.conv{i}.sconv.*``, ``.dwconv.*``, ``.norm.*``,
``.pwconv1.*``, ``.pwconv2.*`` (``[out, in]``, as ``nn.Linear``) and
``feature.conv{i}.gamma``.

Departures from the paper's ConvNeXt, as in the reference repository: the
downsampling layer has no LayerNorm before the patchify conv, and the 7x7
conv has two channels a group, not one (it is not depthwise). The
configuration is eval only: ``train=True`` raises.

It imports only ``torch`` and ``mvster``. ``precision="fp8"`` rounds both
operands of the patchify, grouped and pointwise convs, as ``Net.conv``
does.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from . import mvster

LN_EPS = 1e-6


class Net(mvster.Net):
    """``mvster.Net`` with ``feature.conv{1,2,3}`` as ConvNeXt4 blocks."""

    def __init__(self, p, cfg, *, train: bool = False, precision: str = "float32"):
        if train:
            raise ValueError("the ConvNeXt reference is eval only")
        super().__init__(p, cfg, train=False, precision=precision)

    def pyramid(self, x, views: int) -> List[torch.Tensor]:
        for i in range(2):
            x = self.cbr(x, f"feature.conv0.{i}", 1, views)
        skips = [x]
        for i in (1, 2, 3):
            skips.append(self.block(skips[-1], f"feature.conv{i}"))
        intra = skips[3]
        outs = [self.conv(intra, "feature.out1")]
        for lvl, skip in ((1, skips[2]), (2, skips[1]), (3, skips[0])):
            up = F.interpolate(intra, size=skip.shape[-2:], mode="bilinear", align_corners=True)
            intra = up + self.conv(skip, f"feature.inner{lvl}", bias=True)
            outs.append(self.conv(intra, f"feature.out{lvl + 1}", padding=1))
        return outs

    def pointwise(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x [N, I, H, W]`` through ``name``'s ``[O, I]`` weight and bias."""
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        return F.conv2d(self.q(x), self.q(w)[:, :, None, None], b)

    def block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``convnext4_block`` ``name`` on ``x [N, dim, H, W]`` (module
        docstring) -> ``[N, 2 dim, H / 2, W / 2]``."""
        dim = x.shape[1]
        inp = self.conv(x, f"{name}.sconv", stride=2, bias=True)
        y = F.conv2d(self.q(inp), self.q(self.p[f"{name}.dwconv.weight"]),
                     self.p[f"{name}.dwconv.bias"], 1, 3, 1, dim)
        mean = y.mean(dim=1, keepdim=True)
        var = ((y - mean) ** 2).mean(dim=1, keepdim=True)
        shape = (1, -1, 1, 1)
        y = ((y - mean) / torch.sqrt(var + LN_EPS) * self.p[f"{name}.norm.weight"].view(shape)
             + self.p[f"{name}.norm.bias"].view(shape))
        h = self.pointwise(y, f"{name}.pwconv1")
        h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
        z = self.pointwise(h, f"{name}.pwconv2")
        return inp + self.p[f"{name}.gamma"].view(shape) * z
