"""Cost-volume positional encodings (``--pos_enc 1`` sine, ``2`` learned).

Counterpart of the JAX package's ``models/posenc.py`` (reference
``PosEncSine`` / ``PosEncLearned``, ``mvs4net_utils.py:981-1015``). The
reference parses ``--pos_enc`` and never applies it (``MVS4Net.py:51-52``);
the JAX package adds the encoding to each stage's fused cost volume before
its regularizer, and so does the port (``models/mvs4net.py``).

Both take the volume unfolded, ``x [B, D, H, W, C]``, and the stage's
hypotheses ``depth [B, D, H, W]`` (float32), and return ``x`` plus the
encoding cast to the dtype of ``x``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class PosEncSine(nn.Module):
    """``sin`` / ``cos`` of ``depth / temperature * k * pi`` for ``k <
    C/2``, channels ``[sin..., cos...]``; the angle in float32."""

    def __init__(self, temperature: float = 1000.0):
        super().__init__()
        self.temperature = temperature

    def forward(self, x, depth):
        C = x.shape[-1]
        d = depth.detach().float() / self.temperature
        freqs = torch.arange(C // 2, dtype=torch.float32, device=x.device)
        angle = d[..., None] * freqs * math.pi
        return x + torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(x.dtype)


class PosEncLearned(nn.Module):
    """A learned ``[D, C]`` embedding per (hypothesis, channel),
    ``depth_embed``, drawn uniform in [0, 1) as flax's ``uniform(1.0)``.
    The reference has no key for it: ``pos_enc.{s}.depth_embed`` here,
    ``pos_enc_stage{s+1}/depth_embed`` in the JAX package."""

    def __init__(self, ndepth: int, channels: int):
        super().__init__()
        self.depth_embed = nn.Parameter(torch.empty(ndepth, channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.depth_embed.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x, depth=None):
        return x + self.depth_embed[None, :, None, None, :].to(x.dtype)
