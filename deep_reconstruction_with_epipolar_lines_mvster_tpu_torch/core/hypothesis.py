"""Depth-hypothesis initialisation and coarse-to-fine window scheduling.

Counterpart of the JAX package's ``core/hypothesis.py`` (reference
``models/mvs4net_utils.py:69-106``), including its fix of the reference's
crash-on-use ``schedule_range`` (``ndepth - 1`` where upstream has
``ndepth.device - 1``).
"""

from __future__ import annotations

import torch

from .geometry import resize_align_corners


def init_range(depth_values: torch.Tensor, ndepths: int, h: int, w: int) -> torch.Tensor:
    """Uniform-in-depth hypotheses from a ``[B, >=2]`` (min..max) range,
    ``[B, D, h, w]``."""
    dmin = depth_values[:, 0]
    dmax = depth_values[:, -1]
    itv = (dmax - dmin) / (ndepths - 1)
    steps = torch.arange(ndepths, dtype=depth_values.dtype, device=depth_values.device)
    samples = dmin[:, None] + steps[None, :] * itv[:, None]
    return samples[:, :, None, None].expand(depth_values.shape[0], ndepths, h, w)


def init_inverse_range(
    depth_values: torch.Tensor, ndepths: int, h: int, w: int
) -> torch.Tensor:
    """Uniform-in-inverse-depth hypotheses, index 0 the far plane,
    ``[B, D, h, w]``."""
    inv_min = 1.0 / depth_values[:, 0]
    inv_max = 1.0 / depth_values[:, -1]
    itv = torch.arange(
        ndepths, dtype=depth_values.dtype, device=depth_values.device
    ) / (ndepths - 1)
    inv_hypo = inv_max[:, None] + (inv_min - inv_max)[:, None] * itv[None, :]
    hypo = 1.0 / inv_hypo
    return hypo[:, :, None, None].expand(depth_values.shape[0], ndepths, h, w)


def schedule_inverse_range(
    inverse_min_depth: torch.Tensor,
    inverse_max_depth: torch.Tensor,
    ndepths: int,
    h: int,
    w: int,
) -> torch.Tensor:
    """Inverse-depth window around the previous stage's prediction: D even
    inverse-depth samples between the ``[B, h/2, w/2]`` bounds, resized per
    plane to ``(h, w)`` with align_corners. Returns depths ``[B, D, h, w]``."""
    itv = torch.arange(
        ndepths, dtype=inverse_min_depth.dtype, device=inverse_min_depth.device
    ) / (ndepths - 1)
    inv_hypo = (
        inverse_max_depth[:, None, :, :]
        + (inverse_min_depth - inverse_max_depth)[:, None, :, :]
        * itv[None, :, None, None]
    )
    inv_hypo = resize_align_corners(inv_hypo[..., None], (h, w))[..., 0]
    return 1.0 / inv_hypo


def schedule_range(
    cur_depth: torch.Tensor,
    ndepth: int,
    depth_interval_pixel: torch.Tensor,
    h: int,
    w: int,
) -> torch.Tensor:
    """Linear-in-depth window around ``cur_depth [B, h/2, w/2]`` with a
    ``[B]`` per-sample interval, resized to ``(h, w)``."""
    half = ndepth / 2.0 * depth_interval_pixel[:, None, None]
    dmin = cur_depth - half
    dmax = cur_depth + half
    itv = (dmax - dmin) / (ndepth - 1)
    steps = torch.arange(ndepth, dtype=cur_depth.dtype, device=cur_depth.device)
    samples = dmin[:, None, :, :] + steps[None, :, None, None] * itv[:, None, :, :]
    return resize_align_corners(samples[..., None], (h, w))[..., 0]
