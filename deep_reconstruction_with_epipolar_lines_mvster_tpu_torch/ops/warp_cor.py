"""Epipolar transformer aggregation, the model's hot loop.

Counterpart of the JAX package's ``ops/warp_cor.py`` (reference
``models/mvs4net_utils.py:1027-1102``):

  for each source view v:
      cor_v  = groupwise <warp(feat_v), ref>            [B, D, H, W, G]
      w_v    = softmax_D(sum_G cor_v / T) / sqrt(C)     [B, D, H, W]
      acc   += w_v * cor_v ;  norm += w_v               (norm seeded 1e-8)
  out = acc / norm, folded to [B*D, H, W, G]

In eval, group correlation goes through kernel K1
(``ops/kernels/warp_cor.py``) at every stage. With ``train`` it is the JAX
package's two-step train path instead: the warp through
``ops/warp.py:WarpIK``, whose backward is kernel K3, then the group
correlation in autograd-tracked PyTorch; K1 has no backward, as in JAX
(``models/stagenet.py`` passes ``fuse_cor=... and not train``). The
attention accumulates in float32 and the volume returns in the features'
dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.geometry import grid_sample_2d, relative_projection, warp_coords
from .kernels.warp_cor import group_correlate, warp_cor
from .warp import WarpIK


def correlate_view(
    src_fea: torch.Tensor,     # [B, Hs, Ws, C]
    ref_fea: torch.Tensor,     # [B, H, W, C]
    rel_proj: torch.Tensor,    # [B, 4, 4]
    depth_hypo: torch.Tensor,  # [B, D, H, W] float32
    *,
    group_cor: bool,
    group_dim: int,
    train: bool = False,
) -> torch.Tensor:
    """Warp one source view and correlate it with the reference:
    ``[B, D, H, W, G]`` (group correlation) or the squared difference
    ``[B, D, H, W, C]``. With ``train`` the warp is ``WarpIK``; otherwise
    group correlation is K1 and the squared difference the plain gather."""
    if train:
        warped = WarpIK.apply(src_fea, rel_proj, depth_hypo)
        if group_cor:
            return group_correlate(warped, ref_fea[:, None], group_dim)
    elif group_cor:
        return warp_cor(src_fea, ref_fea, rel_proj, depth_hypo, group_dim)
    else:
        warped = grid_sample_2d(src_fea, warp_coords(rel_proj, depth_hypo))
    diff = ref_fea[:, None] - warped
    return diff * diff


def epipolar_aggregate(
    features: Sequence[torch.Tensor],  # per view [B, H, W, C], ref first
    proj_stacks: torch.Tensor,         # [B, V, 2, 4, 4], ref first
    depth_hypo: torch.Tensor,          # [B, D, H, W] float32
    *,
    group_cor: bool,
    group_dim: int,
    attn_temp: float,
    attn_fuse_d: bool = True,
    train: bool = False,
) -> torch.Tensor:
    """Cross-view attention-weighted cost volume, folded ``[B*D, H, W, G]``
    (G = C without group correlation), in the features' dtype.

    ``attn_fuse_d``: weights ``softmax_D(sum_G cor / attn_temp) / sqrt(C)``;
    otherwise each pixel's weight is the max over D of ``softmax_D(sum_G
    cor)``, broadcast over D. ``train`` picks the train path's warp
    (``correlate_view``)."""
    ref_fea = features[0].contiguous()
    B, H, W, C = ref_fea.shape
    D = depth_hypo.shape[1]
    hypo = depth_hypo.float().contiguous()
    ref_stack = proj_stacks[:, 0]
    acc = 0.0
    norm = 1e-8
    for v in range(1, len(features)):
        rel = relative_projection(proj_stacks[:, v], ref_stack).float().contiguous()
        cor = correlate_view(
            features[v].contiguous(), ref_fea, rel, hypo,
            group_cor=group_cor, group_dim=group_dim, train=train,
        ).float()                                       # [B, D, H, W, G]
        cor_sum = cor.sum(dim=-1)
        if attn_fuse_d:
            w = torch.softmax(cor_sum / attn_temp, dim=1) / math.sqrt(C)
        else:
            w = torch.softmax(cor_sum, dim=1).amax(dim=1, keepdim=True)
        w = w.unsqueeze(-1)
        acc = acc + w * cor
        norm = norm + w
    out = acc / norm
    return out.reshape(B * D, H, W, out.shape[-1]).to(ref_fea.dtype)
