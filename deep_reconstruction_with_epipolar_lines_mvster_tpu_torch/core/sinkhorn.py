"""Entropic optimal-transport (Sinkhorn) depth-distribution loss.

Counterpart of the JAX package's ``core/sinkhorn.py`` (reference
``sinkhorn``, ``models/mvs4net_utils.py:1164-1210``), with the reference's
idiosyncrasies that define training behaviour:

- the transport kernel exponent is ``+cost/eps`` (not the textbook
  ``-cost/eps``), in the iterations and in the final transport map;
- ``log(x + 1e-12)`` of both marginals;
- a fixed number of iterations;
- the discrete path one-hots the hypothesis bin nearest the GT depth;
- the continuous path appends a virtual GT bin whose cost column is the
  fractional inverse-depth bin distance, with unmasked pixels set to 10.
"""

from __future__ import annotations

import torch

from ..parallel.distributed import global_mean


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    m = mask.to(x.dtype)
    return global_mean((x * m).sum(), m.sum(), group)


def sinkhorn_loss(
    gt_depth: torch.Tensor,     # [B, H, W]
    hypo_depth: torch.Tensor,   # [B, D, H, W]
    attn_weight: torch.Tensor,  # [B, D, H, W] predicted distribution
    mask: torch.Tensor,         # [B, H, W] bool
    *,
    iters: int,
    eps: float = 1.0,
    continuous: bool = False,
    group=None,
) -> torch.Tensor:
    """OT loss between the predicted depth-bin distribution and the GT bin:
    the masked mean over pixels of ``sum(T * cost)``, float32; with
    ``group`` the global batch's mean (``parallel.distributed.global_mean``)."""
    B, D, H, W = attn_weight.shape
    f32 = torch.float32
    dev = attn_weight.device
    gt = gt_depth.to(f32)
    hypo = hypo_depth.to(f32)
    pred = attn_weight.to(f32)

    bins = torch.arange(D, dtype=f32, device=dev)
    base_cost = (bins[:, None] - bins[None, :]).abs()   # [D (pred i), D (gt j)]
    pred_dist = pred.permute(0, 2, 3, 1).reshape(B, H * W, D)

    if not continuous:
        gt_idx = (hypo - gt[:, None]).abs().argmin(dim=1)            # [B, H, W]
        # one-hot by comparison: F.one_hot reads the indices' range on the host
        gt_dist = (gt_idx.reshape(B, H * W, 1) == torch.arange(D, device=dev)).to(f32)
        cost = base_cost[None, None]                                 # [1, 1, D, D]
    else:
        gt_dist = torch.zeros((B, H * W, D + 1), dtype=f32, device=dev)
        gt_dist[:, :, -1].fill_(1.0)
        itv = 1.0 / hypo[:, 2] - 1.0 / hypo[:, 1]                     # [B, H, W]
        gt_bin = (1.0 / gt - 1.0 / hypo[:, 0]) / itv
        gt_bin = torch.where(mask, gt_bin, torch.full_like(gt_bin, 10.0))
        gt_col = (gt_bin[:, None] - bins[None, :, None, None]).abs()  # [B, D, H, W]
        gt_col = gt_col.permute(0, 2, 3, 1).reshape(B, H * W, D, 1)
        cost = torch.cat([base_cost.expand(B, H * W, D, D), gt_col], dim=-1)

    log_mu = torch.log(gt_dist + 1e-12)     # [B, HW, n_gt]
    log_nu = torch.log(pred_dist + 1e-12)   # [B, HW, D]
    kernel = cost / eps                     # +cost: the reference's sign

    u = torch.zeros_like(log_nu)
    v = torch.zeros_like(log_mu)
    for _ in range(iters):
        v = log_mu - torch.logsumexp(kernel + u[..., None], dim=-2)
        u = log_nu - torch.logsumexp(kernel + v[..., None, :], dim=-1)

    t_map = torch.exp(kernel + u[..., None] + v[..., None, :])
    per_px = (t_map * cost).sum(dim=(-1, -2)).reshape(B, H, W)
    return _masked_mean(per_px, mask, group)
