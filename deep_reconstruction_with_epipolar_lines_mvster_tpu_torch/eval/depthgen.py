"""Depth-map generation: per-view forward pass + reference artifact layout.

Counterpart of the JAX package's ``eval/depthgen.py`` (reference
``save_depth`` / ``save_scene_depth``, ``test_mvs4.py:332-602``). For each
reference view of each scene it writes, under ``outdir/<scan>/``, the
artifact layout that the fusion stage (and the reference's own filter)
consumes:

  images/{view:08d}.jpg          reference image
  depth_est/{view:08d}.pfm/.png  stage4 depth (+ normalized png)
  confidence/{view:08d}.pfm/.png photometric confidence
  cams/{view:08d}_cam.txt        stage4 (extrinsics, intrinsics)
  ply_local/{view:08d}.ply       optional per-view cloud (--save_ply)
  combined.ply                   accumulated confidence-masked scene cloud

plus timing and device-memory reporting (test_mvs4.py:345-348,600).

The device work of one batch is ``run_forward``: it takes a collated batch
of numpy arrays and returns numpy arrays, with no file I/O, so that a
caller without Pillow or OpenCV (``chip_smoke.py``) runs the same path.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..parallel.mesh import sharded_eval_forward
from ..utils import graphs


def _normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(x)), float(np.max(x))
    return (x - lo) / (hi - lo + 1e-12)


def device_peak_memory_gb() -> float | None:
    """Peak device memory allocated by PyTorch on the current card, in GiB
    (the reference's ``torch.cuda.max_memory_allocated`` report,
    ``test_mvs4.py:338,345-348``); ``None`` without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated() / 1024.0 ** 3


def make_eval_forward(model, devices=None, *, space: int = 1, space_halo: int = 48):
    """The eval forward for depth-map generation: ``forward(imgs, projs, dv)``
    runs ``model`` in ``eval()`` under ``torch.inference_mode()`` and returns
    the stage-4 depth and photometric confidence, the per-stage depths and,
    with ``mono`` where no stage is row-sharded, channel 4 of the stage-2..4
    reference features (saved by the reference's ``--save_jpg --mono``,
    test_mvs4.py:474-489), as tensors on the model's device (on
    ``devices[0]`` with ``devices``).

    Without ``devices`` the forward is captured (``utils/graphs.capture``,
    JAX's ``jax.jit(forward)``): on the card one CUDA graph per input
    signature, replayed on every later call, its outputs fresh tensors; on
    the CPU the eager forward.

    ``devices`` (JAX's ``mesh``): the forward over that device list laid
    out ``(data, space)`` (``parallel.mesh.sharded_eval_forward``): the
    batch split over ``len(devices) // space`` data shards, each image's
    cost-volume stages over ``space`` row windows with ``space_halo`` rows
    of overlap, one model replica a device; eager."""
    model.eval()
    run = model if devices is None else sharded_eval_forward(
        model, devices, space=space, space_halo=space_halo)

    def forward(imgs, projs, dv):
        with torch.inference_mode():
            out = run(imgs, projs, dv)
        res = {
            "depth": out["stage4"]["depth"],
            "confidence": out["stage4"]["photometric_confidence"],
            "stage_depths": [out[f"stage{s}"]["depth"] for s in (1, 2, 3, 4)],
        }
        if all("mono_feat" in out[f"stage{s}"] for s in (2, 3, 4)):
            res["mono_feats"] = [out[f"stage{s}"]["mono_feat"][..., 4].float()
                                 for s in (2, 3, 4)]
        return res

    return forward if devices is not None else graphs.capture(forward, "eval forward")


def _bucket_hw(h: int, w: int, bucket, max_hw) -> Tuple[int, int]:
    """Target padded shape under the bucketing policy: ``0``/falsy = native,
    ``'max'`` = always (max_h, max_w), int N = round up to multiples of N."""
    if not bucket:
        return h, w
    if bucket == "max":
        if max_hw is None:
            return h, w
        return max(h, max_hw[0]), max(w, max_hw[1])
    n = int(bucket)
    up = lambda v: -(-v // n) * n
    return up(h), up(w)


def run_forward(forward, batch, device, *, shape_bucket=0, max_hw=None):
    """The device work of one collated batch: pad the images to the shape
    bucket (bottom/right zeros, as the JAX package does), run ``forward`` on
    ``device``, wait for it, and return ``(out, seconds, shape)``: ``out``
    as numpy arrays cropped back to the native shape, the seconds from the
    host-to-device copy to the results on the host, and the padded
    ``(H, W, V, D)``. The inputs go to a card through pinned memory
    (``utils/graphs.to_device``)."""
    imgs = np.asarray(batch["imgs"])
    dv = np.asarray(batch["depth_values"])
    Bv, Vv, H, W = imgs.shape[:4]
    Hb, Wb = _bucket_hw(H, W, shape_bucket, max_hw)
    if (Hb, Wb) != (H, W):
        padded = np.zeros((Bv, Vv, Hb, Wb, imgs.shape[-1]), imgs.dtype)
        padded[:, :, :H, :W] = imgs
    else:
        padded = imgs

    def t(a):
        return graphs.to_device(a, device)

    t0 = time.perf_counter()
    res = forward(t(padded), {k: t(v) for k, v in batch["proj_matrices"].items()}, t(dv))
    out = {k: ([x.float().cpu().numpy() for x in v] if isinstance(v, list)
               else v.float().cpu().numpy()) for k, v in res.items()}
    seconds = time.perf_counter() - t0
    if (Hb, Wb) != (H, W):  # crop back to the native shape per stage
        out["depth"] = out["depth"][:, :H, :W]
        out["confidence"] = out["confidence"][:, :H, :W]
        for key in ("stage_depths", "mono_feats"):
            if key in out:
                out[key] = [a[:, : H * a.shape[1] // Hb, : W * a.shape[2] // Wb]
                            for a in out[key]]
    return out, seconds, (Hb, Wb, Vv, dv.shape[-1])


def generate_depth_maps(
    model,
    dataset,
    outdir: str,
    *,
    batch_size: int = 1,
    depthgen_thres: float = 0.3,
    save_ply: bool = False,
    save_jpg: bool = False,
    combined_ply: bool = True,
    num_workers: int = 4,
    verbose: bool = True,
    shape_bucket=0,
    max_hw: Tuple[int, int] | None = None,
    forward=None,
) -> Dict[str, float]:
    """Run eval forwards of ``model`` (on its own device) over ``dataset``
    (an EvalDataset-like) and write the artifact tree. Returns timing stats
    (seconds per view).

    Shape bucketing (``shape_bucket``: 0 off, int N = round HxW up to
    N-multiples, ``'max'`` = pad every sample to ``max_hw``) pads the images
    bottom/right with zeros and crops the outputs back, as the JAX package
    does to share one compile; on the card the port likewise captures one
    graph per padded shape (a smaller last batch is a shape of its own). The
    padded image is not bit-exact for the valid region (the FPN
    top-down and the hypothesis windows use align-corners resizes over the
    global extent); ``shape_bucket=0`` keeps the native shape.

    ``forward``: the eval forward to run (``make_eval_forward``, e.g. over a
    device list); by default ``make_eval_forward(model)``.
    """
    from ..data.io import save_image_u8, save_pfm, write_cam_file
    from ..data.loader import DataLoader
    from .fusion import backproject_to_world
    from .ply import write_ply_ascii_colored

    device = next(model.parameters()).device
    if forward is None:
        forward = make_eval_forward(model)

    loader = DataLoader(dataset, batch_size, num_workers=num_workers)
    times: List[float] = []
    n_views = 0
    shapes = set()
    # per-scene accumulated conf-masked world cloud (test_mvs4.py:519-529)
    vertices: List[np.ndarray] = []
    vertex_colors: List[np.ndarray] = []
    scene_dir = None
    for batch in loader:
        imgs = batch["imgs"]
        dv = batch["depth_values"]
        out, seconds, shape = run_forward(forward, batch, device,
                                          shape_bucket=shape_bucket, max_hw=max_hw)
        shapes.add(shape)
        times.append(seconds)

        cams = np.asarray(batch["proj_matrices"]["stage4"])
        for b, filename in enumerate(batch["filename"]):
            n_views += 1
            depth_est = out["depth"][b]
            conf = out["confidence"][b]
            ref_img = np.asarray(imgs[b, 0])

            def path(folder, suffix):
                p = os.path.join(outdir, filename.format(folder, suffix))
                os.makedirs(os.path.dirname(p), exist_ok=True)
                return p

            save_image_u8(path("images", ".jpg"), ref_img)
            save_pfm(path("depth_est", ".pfm"), depth_est.astype(np.float32))
            save_image_u8(path("depth_est", ".png"), _normalize01(depth_est))
            save_pfm(path("confidence", ".pfm"), conf.astype(np.float32))
            save_image_u8(path("confidence", ".png"), np.clip(conf, 0, 1))

            cam = cams[b, 0]
            write_cam_file(
                path("cams", "_cam.txt"), cam[0], cam[1][:3, :3],
                [float(dv[b][0]), float(dv[b][1] - dv[b][0]),
                 float(len(dv[b])), float(dv[b][-1])],
            )

            if save_jpg:
                for s, sd in enumerate(out["stage_depths"]):
                    save_image_u8(path("depth_est", f"stage_{s + 1}.jpg"), _normalize01(sd[b]))
                # mono-feature channel views (reference --save_jpg --mono,
                # test_mvs4.py:474-489: stages 2-4, channel 4)
                for s, mf in enumerate(out.get("mono_feats", [])):
                    save_image_u8(path("depth_est", f"mono_{s + 2}.jpg"), _normalize01(mf[b]))
            if save_ply or combined_ply:
                conf_mask = conf > depthgen_thres
                pts = backproject_to_world(
                    torch.from_numpy(np.ascontiguousarray(depth_est)).to(device),
                    torch.from_numpy(np.ascontiguousarray(cam[1][:3, :3])).to(device),
                    torch.from_numpy(np.ascontiguousarray(cam[0])).to(device),
                ).cpu().numpy()
                xyz = pts[conf_mask]
                rgb = (ref_img[conf_mask] * 255).astype(np.uint8)
                if save_ply:
                    write_ply_ascii_colored(path("ply_local", ".ply"), xyz, rgb)
                if combined_ply:
                    vertices.append(xyz)
                    vertex_colors.append(rgb)
                    scene_dir = os.path.dirname(os.path.dirname(path("images", ".jpg")))

        if verbose:
            print(f"=== view {n_views}/{len(dataset)} fwd={times[-1]:.3f}s", flush=True)

    if combined_ply and vertices and scene_dir is not None:
        write_ply_ascii_colored(
            os.path.join(scene_dir, "combined.ply"),
            np.concatenate(vertices, axis=0),
            np.concatenate(vertex_colors, axis=0),
        )
        if verbose:
            n_pts = sum(len(v) for v in vertices)
            print(f"combined scene cloud: {n_pts} points -> {scene_dir}/combined.ply",
                  flush=True)

    stats = {
        "total_time_s": float(np.sum(times)),
        "avg_time_s": float(np.mean(times)) if times else 0.0,
        "views": float(n_views),
        "forward_shapes": float(len(shapes)),
    }
    stats["shapes"] = sorted(shapes)  # for cross-scene dedup
    if verbose:
        print(f"total time: {stats['total_time_s']:.2f}s  avg: {stats['avg_time_s']:.3f}s/view",
              flush=True)
    return stats
