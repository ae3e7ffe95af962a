"""One cascade stage: aggregation -> regularization -> depth readout.

Counterpart of the JAX package's ``models/stagenet.py`` (reference
``stagenet.forward``, ``models/mvs4net_utils.py:1027-1162``), eval path:

- winner-take-all depth at the argmax of the float32 scores;
- the "OLI" photometric confidence ``max_D(score) / sum_D(score)`` on the
  raw, pre-softmax scores;
- the next stage's inverse-depth window ``1/depth ± split_itv · itv`` with
  ``itv = 1/hypo[:, 2] - 1/hypo[:, 1]``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..ops.warp_cor import epipolar_aggregate


def run_stage(
    features: Sequence[torch.Tensor],   # per view [B, h, w, C], ref first
    proj_stacks: torch.Tensor,          # [B, V, 2, 4, 4]
    depth_hypo: torch.Tensor,           # [B, D, h, w] float32
    regnet: Callable[[torch.Tensor], torch.Tensor],  # folded volume -> [B*D, h, w]
    *,
    group_cor: bool,
    group_dim: int,
    split_itv: float,
    attn_temp: float,
    attn_fuse_d: bool,
    inverse_depth: bool,
) -> Dict[str, torch.Tensor]:
    B, D, H, W = depth_hypo.shape
    cost = epipolar_aggregate(
        features, proj_stacks, depth_hypo,
        group_cor=group_cor, group_dim=group_dim,
        attn_temp=attn_temp, attn_fuse_d=attn_fuse_d,
    )
    score = regnet(cost).float().reshape(B, D, H, W)
    idx = score.argmax(dim=1, keepdim=True)
    depth = torch.gather(depth_hypo, 1, idx)[:, 0]
    out = {
        "depth": depth,
        "hypo_depth": depth_hypo,
        "attn_weight": torch.softmax(score, dim=1),
        "photometric_confidence": torch.gather(score, 1, idx)[:, 0] / score.sum(dim=1),
    }
    if inverse_depth:
        itv = 1.0 / depth_hypo[:, 2] - 1.0 / depth_hypo[:, 1]
        out["inverse_min_depth"] = 1.0 / depth + split_itv * itv
        out["inverse_max_depth"] = 1.0 / depth - split_itv * itv
    return out
