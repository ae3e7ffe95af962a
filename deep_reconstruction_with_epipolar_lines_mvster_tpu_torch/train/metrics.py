"""Depth metrics and the running meter (reference utils.py:103-163).

Counterpart of the JAX package's ``train/metrics.py``: per-image masked
means, then the batch mean; an image with an empty mask contributes 0, and
``valid`` ([B], 1 real / 0 padded) leaves padded samples out of the mean.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _per_image_masked_mean(x, mask, valid: Optional[torch.Tensor] = None):
    m = mask.float()
    per = (x.float() * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1.0)
    if valid is None:
        return per.mean()
    v = valid.float()
    return (per * v).sum() / v.sum().clamp(min=1.0)


def thres_metric(depth_est, depth_gt, mask, thres: float, valid=None) -> torch.Tensor:
    """Fraction of masked pixels with |err| > thres."""
    err = (depth_est - depth_gt).abs()
    return _per_image_masked_mean((err > thres).float(), mask, valid)


def abs_depth_error(depth_est, depth_gt, mask, valid=None) -> torch.Tensor:
    """Mean absolute masked depth error."""
    return _per_image_masked_mean((depth_est - depth_gt).abs(), mask, valid)


def depth_metrics(depth_est, depth_gt, mask, valid=None) -> Dict[str, torch.Tensor]:
    """The reference scalar set (train_mvs4.py:362-366)."""
    out = {"abs_depth_error": abs_depth_error(depth_est, depth_gt, mask, valid)}
    for t in (1, 2, 4, 8):
        out[f"thres{t}mm_error"] = thres_metric(depth_est, depth_gt, mask, float(t), valid)
    return out


class DictAverageMeter:
    """Running mean over scalar dicts (reference utils.py:103-122)."""

    def __init__(self):
        self.data: Dict[str, float] = {}
        self.count = 0

    def update(self, new_input: Dict[str, float]) -> None:
        self.count += 1
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}
