"""Blender synthetic bin-picking (BDS2..BDS8) train/val dataset
(reference datasets/blender4.py).

The port's copy of the JAX package's ``data/blender.py`` (numpy only;
Pillow and OpenCV are imported inside the functions that use them).

Layout consumed (suffix = "_512x640" normally, "_1024x1280" for raw):
  pair file at {datapath}/{pair_fname}
  Cameras{suffix}/{vid:08d}_cam.txt        full-res intrinsics
  Rectified{suffix}/{scan}/rect_C{vid:03d}_L{light:02d}.png
  Depths{suffix}/{scan}/depth_mask_{ref:03d}.png, depth_map_{ref:03d}.pfm

Behavioural parity:
- the ``Nlights "n:total"`` spec: 0 -> light 0 only, negative -> that fixed
  light index, else train samples n of total lights per (scan, view) and val
  samples 2 (blender4.py:52-66);
- stronger jitter (saturation 0.4, contrast 0.5, brightness 0.6, hue 0.01)
  (blender4.py:23). The reference's "10% grayscale" line is a no-op upstream
  (``img.convert('L')`` return value discarded, blender4.py:91) — effective
  behaviour (no grayscale) is matched;
- strict dimension asserts against the expected resolution
  (blender4.py:161,169,193);
- full-res cams => stage4 is the base intrinsics scale (blender4.py:217-231).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .base import color_jitter, proj_pyramid, robust_view_selection, sample_rng
from .io import pyramid_nearest, read_cam_file, read_image, read_pair_file, read_pfm, read_scan_list


class BlenderDataset:
    NDEPTHS = 192

    def __init__(
        self,
        datapath: str,
        listfile: str,
        mode: str,
        nviews: int,
        interval_scale: float = 1.06,
        *,
        rt: bool = False,
        use_raw_train: bool = False,
        pair_fname: str = "pair.txt",
        Nlights: str = "1:1",
        seed: int = 0,
    ):
        assert mode in ("train", "val", "test")
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.interval_scale = interval_scale
        self.rt = rt
        self.use_raw_train = use_raw_train
        # init-time RNG for the light-subset draw in _build_list only;
        # __getitem__ derives a per-sample generator (thread safety).
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.epoch = 0
        nl = Nlights.replace("(", "").replace(")", "").split(":")
        self.Nlights, self.TotLights = int(nl[0]), int(nl[1])
        if use_raw_train:
            self.suffix, self.H, self.W = "_1024x1280", 1024, 1280
        else:
            self.suffix, self.H, self.W = "_512x640", 512, 640
        self.metas = self._build_list(listfile, pair_fname)

    def _build_list(self, listfile: str, pair_fname: str):
        metas = []
        scans = read_scan_list(listfile)
        pairs = read_pair_file(os.path.join(self.datapath, pair_fname))
        for scan in scans:
            for ref_view, src_views in pairs:
                if self.Nlights == 0:
                    metas.append((scan, 0, ref_view, src_views))
                elif self.Nlights < 0:
                    metas.append((scan, -self.Nlights, ref_view, src_views))
                elif self.mode == "val":
                    assert self.Nlights >= 2, "val number of lights must be >= 2"
                    for light in self.rng.choice(self.Nlights, size=2, replace=False):
                        metas.append((scan, int(light), ref_view, src_views))
                else:
                    assert self.Nlights <= self.TotLights
                    for light in self.rng.choice(
                        self.TotLights, size=self.Nlights, replace=False
                    ):
                        metas.append((scan, int(light), ref_view, src_views))
        return metas

    def __len__(self):
        return len(self.metas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __getitem__(self, idx: int) -> Dict:
        scan, light_idx, ref_view, src_views = self.metas[idx]
        rng = sample_rng(self.seed, self.epoch, idx)
        if self.mode == "train" and self.rt:
            view_ids, scale = robust_view_selection(
                rng, ref_view, src_views, self.nviews
            )
        else:
            view_ids = [ref_view] + src_views[: self.nviews - 1]
            scale = 1.0

        mask = (
            read_image(
                os.path.join(
                    self.datapath,
                    f"Depths{self.suffix}/{scan}/depth_mask_{ref_view:0>3}.png",
                )
            )[..., 0]
            * 255.0
            > 10
        ).astype(np.float32)
        assert mask.shape == (self.H, self.W), (
            f"mask dims {mask.shape} != expected {(self.H, self.W)}"
        )
        depth = read_pfm(
            os.path.join(
                self.datapath,
                f"Depths{self.suffix}/{scan}/depth_map_{ref_view:0>3}.pfm",
            )
        )[0].astype(np.float32) * scale
        assert depth.shape == (self.H, self.W)
        mask_ms = pyramid_nearest(mask)
        depth_ms = pyramid_nearest(depth)

        imgs, intr_list, extr_list = [], [], []
        dmin = ditv = None
        for vid in view_ids:
            img = read_image(
                os.path.join(
                    self.datapath,
                    f"Rectified{self.suffix}/{scan}/rect_C{vid:0>3}_L{light_idx:0>2}.png",
                )
            )
            if self.mode == "train":
                img = color_jitter(
                    rng, img,
                    brightness=0.6, contrast=0.5, saturation=0.4, hue=0.01,
                )
            assert img.shape[:2] == (self.H, self.W)
            intrinsics, extrinsics, dmin, ditv, _ = read_cam_file(
                os.path.join(self.datapath, f"Cameras{self.suffix}/{vid:0>8}_cam.txt")
            )
            ditv *= self.interval_scale
            extrinsics = extrinsics.copy()
            if self.rt:
                extrinsics[:3, 3] *= scale
            imgs.append(img)
            intr_list.append(intrinsics)
            extr_list.append(extrinsics)

        dmax = ditv * self.NDEPTHS + dmin
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_pyramid(intr_list, extr_list, base_stage=4),
            "depth": depth_ms,
            "depth_values": np.array([dmin * scale, dmax * scale], dtype=np.float32),
            "mask": mask_ms,
        }
