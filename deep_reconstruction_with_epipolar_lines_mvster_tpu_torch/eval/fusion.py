"""Geometric-consistency depth filtering + multi-view fusion, on the device.

Counterpart of the JAX package's ``eval/fusion.py`` (reference
``test_mvs4.py:612-894``): the ref->src->ref reprojection round trip, the
pixel and relative-depth consistency masks, the consistent-view count and
the fused depth average run as one batched computation over all source
views of a reference view (the JAX ``vmap`` becomes a leading view axis),
in plain PyTorch on the tensors' device. The sampling is the port's own
``core/geometry.grid_sample_2d``: the JAX package computes it outside any
Pallas kernel.

Conventions kept from the reference:
- ``reproject``: lift ref pixels by the ref depth, project into the source,
  bilinearly sample the source depth with zeros padding (``cv2.remap``
  INTER_LINEAR + zero border), lift by the sampled depth, project back
  (test_mvs4.py:612-649); the pixel grid is the corner grid (x = 0, 1, ...);
- consistency: ``dist < condmask_pixel`` and ``|d_rep - d_ref| / d_ref <
  condmask_depth``; inconsistent reprojected depths are zeroed
  (test_mvs4.py:653-670);
- fusion: ``(sum(reprojected) + ref) / (n_consistent + 1)``, geo mask =
  count >= geomask, final = photo and geo (test_mvs4.py:744-749);
- the world-space backprojection uses the pixel-centre grid (0.5 offsets,
  test_mvs4.py:206-229).

``filter_ref_view`` and ``fused_world_points`` take numpy arrays or tensors
and run on ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..core.geometry import extrinsics_inverse, grid_sample_2d, intrinsics_inverse
from ..utils import graphs, trace


class FusionConfig(NamedTuple):
    photomask: float = 0.3          # confidence threshold (--photomask)
    geomask: int = 2                # min consistent views (--geomask)
    condmask_pixel: float = 1.0     # reprojection pixel distance (--condmask_pixel)
    condmask_depth: float = 0.01    # relative depth difference (--condmask_depth)


def _pixel_grid(h: int, w: int, device, *, centered: bool = False) -> torch.Tensor:
    """[H, W, 3] homogeneous float32 pixel coordinates; ``centered`` adds the
    0.5 pixel-centre offset of the reference's world backprojection
    (test_mvs4.py:220-229) but not of its consistency check (:616)."""
    off = 0.5 if centered else 0.0
    xs = torch.arange(w, dtype=torch.float32, device=device) + off
    ys = torch.arange(h, dtype=torch.float32, device=device) + off
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32, device=device)


def backproject_to_world(depth: torch.Tensor, intrinsics: torch.Tensor,
                         extrinsics: torch.Tensor) -> torch.Tensor:
    """Depth map ``[H, W]`` -> world-space points ``[H, W, 3]`` (reference
    depth2pts_np, test_mvs4.py:206-218, pixel-centre convention)."""
    h, w = depth.shape
    uv = _pixel_grid(h, w, depth.device, centered=True) @ intrinsics_inverse(intrinsics).T
    cam_pts = uv * depth[..., None]
    rot = extrinsics[:3, :3]
    t = extrinsics[:3, 3]
    # (p - t) @ R == R^T (p - t) == R^-1 (p - t) for orthonormal R
    return (cam_pts - t) @ rot


def reproject(depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src):
    """Ref->src->ref round trip (reference reproject_with_depth,
    test_mvs4.py:612-649) of ``depth_ref [H, W]`` (cams ``[3, 3]``,
    ``[4, 4]``) through the source views ``depth_src [S, H, W]`` (cams
    ``[S, 3, 3]``, ``[S, 4, 4]``). Returns (depth_reprojected,
    x2d_reprojected, y2d_reprojected), each ``[S, H, W]``."""
    S, h, w = depth_src.shape
    grid = _pixel_grid(h, w, depth_ref.device)   # corner convention, as the reference's

    xyz_ref = (grid @ intrinsics_inverse(intr_ref).T) * depth_ref[..., None]
    # ref cam -> src cam: E_src @ E_ref^-1 (analytic rigid inverse)
    rel = extr_src @ extrinsics_inverse(extr_ref)                          # [S, 4, 4]
    xyz_src = xyz_ref @ rel[:, None, :3, :3].transpose(-1, -2) + rel[:, None, None, :3, 3]
    k_xyz = xyz_src @ intr_src[:, None].transpose(-1, -2)
    xy_src = k_xyz[..., :2] / k_xyz[..., 2:3]                              # [S, H, W, 2]

    # bilinear sample of the source depth at the projected coordinates
    sampled = grid_sample_2d(depth_src[..., None], xy_src)[..., 0]

    # lift by the sampled source depth, project back to the reference
    ones = torch.ones_like(xy_src[..., :1])
    xyz_src2 = (torch.cat([xy_src, ones], dim=-1)
                @ intrinsics_inverse(intr_src)[:, None].transpose(-1, -2)) * sampled[..., None]
    rel_back = extr_ref @ extrinsics_inverse(extr_src)                     # [S, 4, 4]
    xyz_rep = (xyz_src2 @ rel_back[:, None, :3, :3].transpose(-1, -2)
               + rel_back[:, None, None, :3, 3])
    depth_rep = xyz_rep[..., 2]
    k_rep = xyz_rep @ intr_ref.T
    xy_rep = k_rep[..., :2] / k_rep[..., 2:3]
    return depth_rep, xy_rep[..., 0], xy_rep[..., 1]


def check_geometric_consistency(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                                extr_src, *, condmask_pixel: float, condmask_depth: float):
    """(mask, depth_reprojected-with-zeros), each ``[S, H, W]`` — reference
    check_geometric_consistency (test_mvs4.py:653-670), for all source views
    at once."""
    h, w = depth_ref.shape
    grid = _pixel_grid(h, w, depth_ref.device)
    depth_rep, x_rep, y_rep = reproject(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src
    )
    dist = torch.sqrt((x_rep - grid[..., 0]) ** 2 + (y_rep - grid[..., 1]) ** 2)
    rel_diff = (depth_rep - depth_ref).abs() / depth_ref
    mask = (dist < condmask_pixel) & (rel_diff < condmask_depth)
    return mask, torch.where(mask, depth_rep, torch.zeros_like(depth_rep))


def _filter(depth_ref, conf_ref, intr_ref, extr_ref, src_depths, src_intrs, src_extrs,
            cfg: FusionConfig) -> Dict[str, torch.Tensor]:
    """The device work of ``filter_ref_view`` on tensors, the source views
    stacked ``[S, ...]``."""
    masks, depths_rep = check_geometric_consistency(
        depth_ref, intr_ref, extr_ref, src_depths, src_intrs, src_extrs,
        condmask_pixel=cfg.condmask_pixel, condmask_depth=cfg.condmask_depth,
    )                                                                      # [S, H, W]
    geo_count = masks.to(torch.int32).sum(dim=0)
    fused = (depths_rep.sum(dim=0) + depth_ref) / (geo_count + 1).to(torch.float32)
    photo_mask = conf_ref > cfg.photomask
    geo_mask = geo_count >= cfg.geomask
    return {
        "photo_mask": photo_mask,
        "geo_mask": geo_mask,
        "final_mask": photo_mask & geo_mask,
        "fused_depth": fused,
    }


# captured on the card once per (H, W, source views, cfg), as the JAX
# package jits its per-view check (JAX eval/fusion.py:128)
_filter_graphs = graphs.capture(_filter, "filter_ref_view")


def filter_ref_view(
    depth_ref,
    conf_ref,
    intr_ref,
    extr_ref,
    src_depths: Sequence,
    src_intrs: Sequence,
    src_extrs: Sequence,
    cfg: FusionConfig = FusionConfig(),
    *,
    device=None,
) -> Dict[str, np.ndarray]:
    """Filter + fuse one reference view against its source views, all
    source views in one batched computation on ``device`` (the card unless
    ``device="cpu"``). On the card the computation is a CUDA graph per
    ``(H, W)``, number of source views and ``cfg`` (``utils/graphs``).
    Inputs are numpy arrays or tensors; returns numpy. Spans
    (``utils/trace``): ``fusion.filter``, and inside it ``fusion.upload``
    (the inputs to ``device``), the captured call (``graph.replay`` on the
    card) and ``fusion.download`` (the results to the host)."""
    with trace.span("fusion.filter"):
        dev = resolve_device(device)
        with trace.span("fusion.upload"):
            args = (_t(depth_ref, dev), _t(conf_ref, dev), _t(intr_ref, dev),
                    _t(extr_ref, dev), torch.stack([_t(d, dev) for d in src_depths]),
                    torch.stack([_t(k, dev) for k in src_intrs]),
                    torch.stack([_t(e, dev) for e in src_extrs]))
        out = _filter_graphs(*args, cfg)
        with trace.span("fusion.download"):
            return {k: v.cpu().numpy() for k, v in out.items()}


def fused_world_points(
    fused_depth,
    final_mask,
    intr,
    extr,
    image01=None,
    *,
    device=None,
):
    """Masked world-space vertices (+ colours) for one reference view
    (test_mvs4.py:781-793), backprojected on ``device``; numpy results.
    The call is a ``fusion.gather`` span (``utils/trace``)."""
    with trace.span("fusion.gather"):
        dev = resolve_device(device)
        pts = backproject_to_world(_t(fused_depth, dev), _t(intr, dev), _t(extr, dev))
        m = torch.as_tensor(np.asarray(final_mask, bool)
                            if not isinstance(final_mask, torch.Tensor) else final_mask,
                            dtype=torch.bool, device=dev)
        xyz = pts[m].cpu().numpy()
        rgb = None
        if image01 is not None:
            rgb = (np.asarray(image01)[m.cpu().numpy()] * 255.0).astype(np.uint8)
        return xyz, rgb
