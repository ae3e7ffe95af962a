"""Plain float32 MVSTER with DCN heads: the eval forward of ``mvster.Net``
with each of the four pyramid outputs passed through the reference
repository's ``NA_DCN`` head (``models/mvs4net_utils.py:410-424``, its
``--dcn`` flag): eval BatchNorm, ReLU, then ``DeformConvPack``, the
deformable convolution of Dai et al. (arXiv:1703.06211).

Parameters are read by the reference repository's ``state_dict`` names:
``feature.dcn{i}.0.*`` (the BatchNorm), ``feature.dcn{i}.2.conv_offset.*``
(the offset conv, 3x3, padding 1, with bias, 18 outputs) and
``feature.dcn{i}.2.weight`` (the deformable conv's ``[C, C, 3, 3]``).
Tap ``k`` (row-major ``ky, kx``) of output pixel ``(h, w)`` samples its
input at ``(h + ky - 1 + off[2k], w + kx - 1 + off[2k + 1])``, the row
offset before the column offset as ``DeformConvPack`` orders them,
bilinearly with zeros outside the image (``F.grid_sample``, align
corners); the nine samples then contract against the weight in float32.

Departures from the paper's description, as in the reference repository:
DCN v1 (no modulation mask), one deformable group, and no bias on the
deformable conv. The configuration is eval only: ``train=True`` raises.

It imports only ``torch`` and ``mvster``. ``precision="fp8"`` rounds both
operands of the offset conv and of the contraction, as ``Net.conv`` does.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from . import mvster


class Net(mvster.Net):
    """``mvster.Net`` whose pyramid outputs pass through ``feature.dcn{i}``."""

    def __init__(self, p, cfg, *, train: bool = False, precision: str = "float32"):
        if train:
            raise ValueError("the DCN reference is eval only")
        super().__init__(p, cfg, train=False, precision=precision)

    def pyramid(self, x, views: int) -> List[torch.Tensor]:
        return [self.head(o, f"feature.dcn{i + 1}")
                for i, o in enumerate(super().pyramid(x, views))]

    def head(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``NA_DCN`` on ``x [N, C, H, W]``."""
        x = F.relu(self.bn(x, f"{name}.0"))
        off = self.conv(x, f"{name}.2.conv_offset", padding=1, bias=True)
        N, C, H, W = x.shape
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                                torch.arange(W, dtype=torch.float32, device=x.device),
                                indexing="ij")
        taps = []
        for k in range(9):
            ky, kx = divmod(k, 3)
            py = ys + (ky - 1) + off[:, 2 * k]
            px = xs + (kx - 1) + off[:, 2 * k + 1]
            grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], dim=-1)
            taps.append(F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                      align_corners=True))
        cols = torch.stack(taps, dim=2)                            # [N, C, 9, H, W]
        w = self.p[f"{name}.2.weight"].reshape(-1, C, 9)           # [O, C, 9], k = 3 ky + kx
        return torch.einsum("nckhw,ock->nohw", self.q(cols), self.q(w))
