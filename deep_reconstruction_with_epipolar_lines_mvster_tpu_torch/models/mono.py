"""Auxiliary monocular depth decoder, run in training only.

Counterpart of the JAX package's ``models/mono.py`` ``MonoDepthDecoder``
(reference ``mono_depth_decoder``, ``mvs4net_utils.py:840-882``): for
stages 1-3, a ConvBnReLU on the stage's reference-view features, an x2
upsample, a concat with the next stage's features and a 3x3 conv to a
sigmoid disparity scaled into ``[1/d_max, 1/d_min]``, inverted to the depth
map of stages 2-4. State-dict keys follow the reference:
``mono_depth_decoder.convblocks.{i}`` and ``mono_depth_decoder.conv3x3.{i}``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..core.geometry import resize_align_corners, upsample_nearest_2x
from .layers import ConvBnReLU, ConvWeight, conv2d_nhwc


class MonoDepthDecoder(nn.Module):
    """``channels``: the stages' feature widths, coarse to fine."""

    def __init__(self, channels: Sequence[int], interp: str = "nearest"):
        super().__init__()
        self.interp = interp
        self.convblocks = nn.ModuleList(
            ConvBnReLU(channels[i], channels[i + 1], 3) for i in range(len(channels) - 1)
        )
        self.conv3x3 = nn.ModuleList(
            ConvWeight((1, 2 * channels[i + 1], 3, 3), bias=True)
            for i in range(len(channels) - 1)
        )

    def forward(
        self,
        mono_feats: Sequence[torch.Tensor],  # [B, h_i, w_i, C_i] per stage
        d_min: torch.Tensor,                 # [B]
        d_max: torch.Tensor,                 # [B]
    ) -> List[torch.Tensor]:
        out = []
        for i, (block, head) in enumerate(zip(self.convblocks, self.conv3x3)):
            large = mono_feats[i + 1]
            small = block(mono_feats[i])
            if self.interp == "nearest":
                small = upsample_nearest_2x(small)
            else:
                small = resize_align_corners(small, large.shape[1:3])
            feat = conv2d_nhwc(torch.cat([small, large], dim=-1), head.weight,
                               head.bias, padding=1)
            disp = torch.sigmoid(feat)[..., 0]              # [B, H, W]
            min_disp = (1.0 / d_max)[:, None, None]
            max_disp = (1.0 / d_min)[:, None, None]
            out.append(1.0 / (min_disp + (max_disp - min_disp) * disp))
        return out
