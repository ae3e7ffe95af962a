"""Scene-level filtering: consume the depth-gen artifact tree, run the
consistency filter per reference view on the device, write masks and the
fused PLY.

Counterpart of the JAX package's ``eval/scene_filter.py`` (reference
``filter_depth``, ``test_mvs4.py:674-894``, minus the interactive Open3D
plotting). Artifacts written under ``scene_folder``:

  mask/{view:08d}_photo.png / _geo.png / _final.png
  _fused_3Dpts.ply                       (when save_ply)
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Sequence

import numpy as np

from ..data.io import read_cam_file, read_image, read_pair_file, read_pfm
from ..utils import trace
from .fusion import FusionConfig, filter_ref_view, fused_world_points
from .ply import write_ply


def fuse_view(ref_view: int, src_views: Sequence[int], depths: Mapping, confs: Mapping,
              cams: Mapping, images: Mapping, cfg: FusionConfig = FusionConfig(), *,
              device=None) -> Dict[str, object]:
    """The filter's work for one reference view, on arrays: ``ref_view``
    filtered against ``src_views`` (``filter_ref_view``, all sources in one
    batched computation) and its fused world points
    (``fused_world_points``), on ``device``. ``depths``, ``confs`` and
    ``images`` map a view to its depth map, confidence and [0, 1] image (or
    ``None``), ``cams`` to its ``(intrinsics, extrinsics)``. Returns the
    masks and fused depth of ``filter_ref_view``, the points ``xyz`` and
    colours ``rgb``, and each mask's share of the pixels (``shares``). The
    call is a ``fusion.view`` span (``utils/trace``), around the filter's
    ``fusion.filter`` and the points' ``fusion.gather``."""
    with trace.span("fusion.view"):
        intr, extr = cams[ref_view]
        out = filter_ref_view(
            depths[ref_view], confs[ref_view], intr, extr,
            [depths[s] for s in src_views],
            [cams[s][0] for s in src_views],
            [cams[s][1] for s in src_views],
            cfg, device=device,
        )
        xyz, rgb = fused_world_points(out["fused_depth"], out["final_mask"], intr, extr,
                                      images[ref_view], device=device)
        shares = {k: float(out[f"{k}_mask"].mean()) for k in ("photo", "geo", "final")}
        return {**out, "xyz": xyz, "rgb": rgb, "shares": shares}


def filter_scene(
    scene_folder: str,
    pair_file: str,
    *,
    nview_filter: int = 4,
    cfg: FusionConfig = FusionConfig(),
    save_ply: bool = True,
    save_masks: bool = True,
    verbose: bool = True,
    debug_bits: int = 0,
    device=None,
) -> Dict[str, float]:
    """Filter + fuse every reference view of one scene on ``device`` (the
    card unless ``device="cpu"``). Returns coverage stats."""
    from PIL import Image

    pair_data = read_pair_file(pair_file)

    vertices: List[np.ndarray] = []
    colors: List[np.ndarray] = []
    stats = {"photo": [], "geo": [], "final": [], "time": []}

    # per-view data is read once (the reference re-reads it per pair)
    cams, depths, confs, images = {}, {}, {}, {}

    def load(view: int):
        if view in depths:
            return
        intr, extr, *_ = read_cam_file(os.path.join(scene_folder, f"cams/{view:0>8}_cam.txt"))
        cams[view] = (intr, extr)
        depths[view] = read_pfm(os.path.join(scene_folder, f"depth_est/{view:0>8}.pfm"))[0]
        conf_p = os.path.join(scene_folder, f"confidence/{view:0>8}.pfm")
        confs[view] = read_pfm(conf_p)[0] if os.path.exists(conf_p) else None
        img_p = os.path.join(scene_folder, f"images/{view:0>8}.jpg")
        images[view] = read_image(img_p) if os.path.exists(img_p) else None

    for ref_view, src_views in pair_data:
        t0 = time.perf_counter()
        src_views = src_views[: nview_filter - 1]
        load(ref_view)
        for s in src_views:
            load(s)
        out = fuse_view(ref_view, src_views, depths, confs, cams, images, cfg, device=device)
        dt = time.perf_counter() - t0
        for name in ("photo", "geo", "final"):
            stats[name].append(out["shares"][name])
        stats["time"].append(dt)

        if save_masks:
            os.makedirs(os.path.join(scene_folder, "mask"), exist_ok=True)
            for name in ("photo", "geo", "final"):
                Image.fromarray(
                    (out[f"{name}_mask"].astype(np.uint8) * 255)
                ).save(os.path.join(scene_folder, f"mask/{ref_view:0>8}_{name}.png"))

        if debug_bits:
            # --debug_depth_filter: numeric dumps in place of the reference's
            # interactive filter windows (test_mvs4.py:736-823): bit 0 =
            # masks, bit 1 = fused/input depth
            dbg = os.path.join(scene_folder, "debug")
            os.makedirs(dbg, exist_ok=True)
            sel = {}
            if debug_bits & 1:
                sel.update({k: out[k] for k in ("photo_mask", "geo_mask", "final_mask")})
            if debug_bits & 2:
                sel.update({"fused_depth": out["fused_depth"], "input_depth": depths[ref_view]})
            for k, v in sel.items():
                np.save(os.path.join(dbg, f"{ref_view:0>8}_{k}.npy"), np.asarray(v))

        vertices.append(out["xyz"])
        if out["rgb"] is not None:
            colors.append(out["rgb"])

        if verbose:
            print(
                f"ref-view{ref_view:0>2} photo/geo/final: "
                f"{out['shares']['photo'] * 100:.2f}/"
                f"{out['shares']['geo'] * 100:.2f}/"
                f"{out['shares']['final'] * 100:.2f}  time={dt:.3f}s",
                flush=True,
            )

    all_xyz = np.concatenate(vertices, axis=0) if vertices else np.zeros((0, 3))
    all_rgb = np.concatenate(colors, axis=0) if colors else None
    if save_ply:
        ply_path = os.path.join(scene_folder, "_fused_3Dpts.ply")
        write_ply(ply_path, all_xyz, all_rgb)
        if verbose:
            print(f"saved fused cloud ({len(all_xyz)} pts) to {ply_path}")

    return {
        "n_points": float(len(all_xyz)),
        "photo_coverage": float(np.mean(stats["photo"])) if stats["photo"] else 0.0,
        "geo_coverage": float(np.mean(stats["geo"])) if stats["geo"] else 0.0,
        "final_coverage": float(np.mean(stats["final"])) if stats["final"] else 0.0,
        "avg_filter_time_s": float(np.mean(stats["time"])) if stats["time"] else 0.0,
    }
