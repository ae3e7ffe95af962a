"""Plain geometric-consistency filter and fusion of one reference view,
written from the reference repository's ``test_mvs4.py`` (``reproject_with_depth``,
``check_geometric_consistency``, ``filter_depth``, ``depth2pts_np``).

It imports only ``torch``. Matrices are inverted with ``torch.linalg.inv``
in float64; the rest is float32. Bilinear sampling of a source depth map
is ``F.grid_sample`` (align corners, zeros padding), as ``cv2.remap`` with
a zero border samples it on the pixel-corner grid.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _inv(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(m.double()).float()


def _grid(h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)       # [h, w, 3]


def reproject(d_ref, k_ref, e_ref, d_src, k_src, e_src):
    """Lift the reference pixels by their depth, project into the source,
    sample its depth, lift it and project back: the reprojected depth and
    pixel coordinates ``[h, w]`` each."""
    h, w = d_ref.shape
    pix = _grid(h, w, d_ref.device)
    cam = (pix @ _inv(k_ref).T) * d_ref[..., None]
    world = torch.cat([cam, torch.ones_like(cam[..., :1])], -1) @ _inv(e_ref).T
    cam_src = (world @ e_src.T)[..., :3]
    xy = cam_src @ k_src.T
    xy = xy[..., :2] / xy[..., 2:3]
    gx = xy[..., 0] / (w - 1) * 2 - 1
    gy = xy[..., 1] / (h - 1) * 2 - 1
    sampled = F.grid_sample(d_src[None, None], torch.stack([gx, gy], -1)[None],
                            mode="bilinear", padding_mode="zeros", align_corners=True)[0, 0]
    cam2 = (torch.cat([xy, torch.ones_like(xy[..., :1])], -1) @ _inv(k_src).T) * sampled[..., None]
    world2 = torch.cat([cam2, torch.ones_like(cam2[..., :1])], -1) @ _inv(e_src).T
    back = (world2 @ e_ref.T)[..., :3]
    depth = back[..., 2]
    xy2 = back @ k_ref.T
    return depth, xy2[..., 0] / xy2[..., 2], xy2[..., 1] / xy2[..., 2]


def filter_view(d_ref, conf_ref, cam_ref, sources, cfg: Dict) -> Dict[str, torch.Tensor]:
    """One reference view against its ``sources`` (``(depth, (K, E))`` each):
    the photometric, geometric and final masks and the fused depth."""
    k_ref, e_ref = cam_ref
    h, w = d_ref.shape
    pix = _grid(h, w, d_ref.device)
    count = torch.zeros((h, w), dtype=torch.int32, device=d_ref.device)
    total = d_ref.clone()
    for d_src, (k_src, e_src) in sources:
        depth, x2, y2 = reproject(d_ref, k_ref, e_ref, d_src, k_src, e_src)
        dist = torch.sqrt((x2 - pix[..., 0]) ** 2 + (y2 - pix[..., 1]) ** 2)
        rel = (depth - d_ref).abs() / d_ref
        ok = (dist < cfg["condmask_pixel"]) & (rel < cfg["condmask_depth"])
        count += ok.int()
        total = total + torch.where(ok, depth, torch.zeros_like(depth))
    fused = total / (count + 1).float()
    photo = conf_ref > cfg["photomask"]
    geo = count >= cfg["geomask"]
    return {"photo_mask": photo, "geo_mask": geo, "final_mask": photo & geo,
            "fused_depth": fused}
