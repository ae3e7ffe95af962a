"""Training losses (reference models/MVS4Net.py:195-291).

Counterpart of the JAX package's ``models/losses.py``:

``mvs4net_loss``: per stage, the masked L1 of the mono depth (stages >= 2,
with ``mono``), the Sinkhorn OT loss between the attention distribution and
the GT bin, and the out-of-range diagnostic ``s{s}_range_err_ratio``; total
``= sum_s stage_lw[s] * (l1_lw * L1 + ot_lw * OT)``.

``blend_loss``: the same plus EPE / <=1px / <=3px on the depth scaled to a
128-unit range (BlendedMVS convention, reference ``Blend_loss``).

Every reduction is a mask-weighted mean in float32. With ``group`` (a
process group: the global batch of ``dp_impl="gspmd"``), the mean is the
global batch's, as the JAX package's under GSPMD: each denominator is
summed over the group's ranks and each rank's numerator scaled by their
number, so that the ranks' mean of a value (and of its gradient, DDP's
average) is the global masked mean.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import LossConfig
from ..core.sinkhorn import sinkhorn_loss
from ..parallel.distributed import global_mean


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    m = mask.float()
    return global_mean((x.float() * m).sum(), m.sum(), group)


def mvs4net_loss(
    outputs: Dict[str, Dict[str, torch.Tensor]],
    depth_gt_ms: Dict[str, torch.Tensor],
    mask_ms: Dict[str, torch.Tensor],
    cfg: LossConfig,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(total, aux)``: aux holds ``s{s}_d_loss`` (mono L1),
    ``s{s}_c_loss`` (OT) and ``s{s}_range_err_ratio`` per stage; ``group``:
    the global batch's masked means (module docstring)."""
    stage_keys = sorted(k for k in outputs if k.startswith("stage"))
    total = torch.zeros((), device=outputs[stage_keys[0]]["attn_weight"].device)
    aux: Dict[str, torch.Tensor] = {}
    for s, key in enumerate(stage_keys):
        stage = outputs[key]
        hypo = stage["hypo_depth"]
        mask = mask_ms[key] > 0.5
        gt = depth_gt_ms[key]

        if cfg.mono and s != 0 and "mono_depth" in stage:
            l1 = _masked_mean((stage["mono_depth"] - gt).abs(), mask, group)
        else:
            l1 = torch.zeros((), device=total.device)

        # out-of-range diagnostic (MVS4Net.py:226-232)
        with torch.no_grad():
            if cfg.inverse_depth:
                itv = (1.0 / hypo[:, 2] - 1.0 / hypo[:, 1]).abs()
                inside = ((1.0 / hypo - 1.0 / gt[:, None]).abs() <= itv[:, None]).sum(dim=1)
            else:
                itv = (hypo[:, 2] - hypo[:, 1]).abs()
                inside = ((hypo - gt[:, None]).abs() <= itv[:, None]).sum(dim=1)
            aux[f"s{s}_range_err_ratio"] = _masked_mean((inside == 0).float(), mask, group)

        ot = sinkhorn_loss(
            gt, hypo, stage["attn_weight"], mask,
            iters=cfg.ot_iter, eps=cfg.ot_eps, continuous=cfg.ot_continuous, group=group,
        )
        aux[f"s{s}_d_loss"] = l1
        aux[f"s{s}_c_loss"] = ot
        total = total + cfg.stage_lw[s] * (cfg.l1_lw * l1 + cfg.ot_lw * ot)
    return total, aux


def blend_loss(
    outputs: Dict[str, Dict[str, torch.Tensor]],
    depth_gt_ms: Dict[str, torch.Tensor],
    mask_ms: Dict[str, torch.Tensor],
    cfg: LossConfig,
    depth_min: torch.Tensor,  # [B]
    depth_max: torch.Tensor,  # [B]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    total, aux = mvs4net_loss(outputs, depth_gt_ms, mask_ms, cfg)
    last = sorted(k for k in outputs if k.startswith("stage"))[-1]
    mask = mask_ms[last] > 0.5
    with torch.no_grad():
        scale = 128.0 / (depth_max - depth_min)[:, None, None]
        abs_err = (outputs[last]["depth"] * scale - depth_gt_ms[last] * scale).abs()
        aux["epe"] = _masked_mean(abs_err, mask)
        aux["err1"] = _masked_mean((abs_err <= 1.0).float(), mask) * 100.0
        aux["err3"] = _masked_mean((abs_err <= 3.0).float(), mask) * 100.0
    return total, aux
