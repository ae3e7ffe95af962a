"""The benchmark's scene generator: textured slanted planes seen by a row of
cameras, rendered analytically on the device in bulk.

A frozen copy of the plane scene of the program's ``data/synthetic.py``
(``make_plane_scene``), vectorised over scenes and views with ``torch`` so
that a pool of full-size scenes is made in a few calls on the card. Each
scene's plane ``Z = z0 + gx X + gy Y`` (world = the first camera's frame),
camera spacing and texture phase are drawn from the seed; every seed gets
the same sizes.

A traffic mix is a JSON file beside this one (``traffic/<name>.json``):
``batch``, ``views``, ``height``, ``width``, ``pool`` (scenes or batches
made in set-up) and the ranges of the scene draws; its ``tiny`` entry
overrides sizes for the CPU mode of the benchmark's own tests.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def scene_params(rng: np.random.Generator, n: int, views: int, mix: Dict) -> Dict[str, np.ndarray]:
    """Per-scene draws: plane offset and slants, camera spacing and
    vertical jitter, texture phases."""
    r = mix["ranges"]

    def u(key, shape=()):
        lo, hi = r[key]
        return rng.uniform(lo, hi, size=(n, *shape))

    return {"z0": u("z0"), "gx": u("gx"), "gy": u("gy"), "baseline": u("baseline"),
            "jitter": u("jitter", (views,)), "phase": rng.uniform(0, 2 * math.pi, (n, 3))}


def render(params: Dict[str, np.ndarray], views: int, H: int, W: int, depth_range,
           device, with_targets: bool = False) -> Dict:
    """The scenes of ``params`` as tensors on ``device``: ``imgs [n, V, H,
    W, 3]`` float32 in [0, 1], ``proj_matrices {stageK: [n, V, 2, 4, 4]}``
    (extrinsics, intrinsics scaled to stage K), ``depth_values [n, 2]``;
    with ``with_targets`` also ``depth`` and ``mask {stageK: [n, h, w]}``
    of the first camera."""
    f64 = torch.float64
    n = len(params["z0"])
    P = {k: torch.as_tensor(v, dtype=f64, device=device) for k, v in params.items()}
    f = 0.9 * W
    K = torch.tensor([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], dtype=f64, device=device)
    v_idx = torch.arange(views, dtype=f64, device=device)
    # camera v sits at x = baseline * v, y = jitter * baseline (none for v = 0)
    tx = -P["baseline"][:, None] * v_idx[None]
    ty = P["jitter"] * P["baseline"][:, None] * (v_idx[None] > 0)
    centre = torch.stack([-tx, -ty, torch.zeros_like(tx)], dim=-1)       # [n, V, 3]
    normal = torch.stack([-P["gx"], -P["gy"], torch.ones_like(P["gx"])], dim=-1)  # [n, 3]

    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=device),
                            torch.arange(W, dtype=f64, device=device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)             # [H, W, 3]
    ray = pix @ torch.linalg.inv(K).T                                    # [H, W, 3]
    # s solves n . (C + s ray) = z0 along each camera's rays (rotation identity)
    denom = torch.einsum("hwc,nc->nhw", ray, normal)[:, None]            # [n, 1, H, W]
    num = P["z0"][:, None] - (centre * normal[:, None]).sum(-1)          # [n, V]
    s = num[:, :, None, None] / denom                                    # [n, V, H, W]
    X = centre[..., 0, None, None] + s * ray[..., 0]
    Y = centre[..., 1, None, None] + s * ray[..., 1]
    ph = P["phase"][:, None, None, None]
    r = 0.5 + 0.5 * torch.sin(0.37 * X + ph[..., 0]) * torch.cos(0.23 * Y)
    g = 0.5 + 0.5 * torch.sin(0.11 * X + 1.3 + ph[..., 1]) * torch.sin(0.31 * Y + 0.7)
    b = 0.5 + 0.25 * torch.cos(0.19 * X * Y / 50.0 + ph[..., 2]) + 0.25 * torch.sin(0.41 * Y)
    imgs = torch.stack([r, g, b], dim=-1).float()

    extr = torch.eye(4, dtype=f64, device=device).repeat(n, views, 1, 1)
    extr[..., 0, 3] = tx
    extr[..., 1, 3] = ty
    out = {"imgs": imgs, "proj_matrices": {}, "depth_values": torch.tensor(
        depth_range, dtype=torch.float32, device=device).repeat(n, 1)}
    if with_targets:
        out["depth"], out["mask"] = {}, {}
    for st in range(4):
        scale = 2.0 ** (st - 3)
        h, w = int(H * scale), int(W * scale)
        stack = torch.zeros((n, views, 2, 4, 4), dtype=f64, device=device)
        stack[:, :, 0] = extr
        Ks = K.clone()
        Ks[:2] *= scale
        stack[:, :, 1, :3, :3] = Ks
        out["proj_matrices"][f"stage{st + 1}"] = stack.float()
        if with_targets:
            yy, xx = torch.meshgrid(torch.arange(h, dtype=f64, device=device),
                                    torch.arange(w, dtype=f64, device=device), indexing="ij")
            ray_s = torch.stack([xx, yy, torch.ones_like(xx)], -1) @ torch.linalg.inv(Ks).T
            depth = P["z0"][:, None, None] / torch.einsum("hwc,nc->nhw", ray_s, normal)
            out["depth"][f"stage{st + 1}"] = (depth * ray_s[..., 2]).float()
            out["mask"][f"stage{st + 1}"] = torch.ones((n, h, w), device=device)
    return out
