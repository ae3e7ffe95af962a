"""DTU train/val dataset (reference datasets/dtu_yao4.py, Yao Yao's
preprocessed DTU layout).

The port's copy of the JAX package's ``data/dtu.py`` (numpy only;
Pillow and OpenCV are imported inside the functions that use them).

Layout consumed:
  Cameras/pair.txt                      shared 49-view pair file
  Cameras/train/{vid:08d}_cam.txt       quarter-res intrinsics
  Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png
  Rectified_raw/{scan}/...              (use_raw_train)
  Depths_raw/{scan}/depth_visual_{vid:04d}.png, depth_map_{vid:04d}.pfm

Behavioural parity (file:line cites into the reference):
- metas = scans x 49 ref views x 7 lights (dtu_yao4.py:39-53);
- GT depth/mask read at high res then downsample(x1/2 nearest)+center-crop to
  512x640, or center-crop 1024x1280 with intrinsics x2 under use_raw_train
  (dtu_yao4.py:87-99,173-187);
- robust training: random source-view subset + scale in [0.8, 1.25] applied
  to extrinsics translation, GT depth and depth_values (dtu_yao4.py:138-145,
  181-183,196-198);
- depth_values = [dmin*s, (dmin + 192*interval*interval_scale)*s]
  (dtu_yao4.py:196-198);
- cams are quarter-res => stage2 is the base intrinsics scale
  (dtu_yao4.py:212-225).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .base import color_jitter, proj_pyramid, robust_view_selection, sample_rng
from .io import pyramid_nearest, read_cam_file, read_image, read_pair_file, read_pfm, read_scan_list


class DTUDataset:
    NDEPTHS = 192  # hardcoded in the reference (dtu_yao4.py:19)
    NUM_LIGHTS = 7

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
        self.seed = seed
        self.epoch = 0
        self.metas = self._build_list(listfile)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-sample augmentation RNG stream (called by the
        DataLoader each epoch, DistributedSampler.set_epoch-style)."""
        self.epoch = epoch

    def _build_list(self, listfile: str):
        metas = []
        scans = read_scan_list(listfile)
        pair_path = os.path.join(self.datapath, "Cameras/pair.txt")
        pairs = read_pair_file(pair_path)
        for scan in scans:
            for ref_view, src_views in pairs:
                for light_idx in range(self.NUM_LIGHTS):
                    metas.append((scan, light_idx, ref_view, src_views))
        return metas

    def __len__(self):
        return len(self.metas)

    # -- reference crop pipeline (dtu_yao4.py:87-99) --------------------------
    def _crop_hr(self, hr: np.ndarray) -> np.ndarray:
        h, w = hr.shape[:2]
        if not self.use_raw_train:
            from .io import resize_nearest

            ds = resize_nearest(hr, (w // 2, h // 2))
            h, w = ds.shape[:2]
            sh, sw = (h - 512) // 2, (w - 640) // 2
            return ds[sh : sh + 512, sw : sw + 640]
        sh, sw = h // 2 - 512, w // 2 - 640
        return hr[sh : sh + 1024, sw : sw + 1280]

    def _crop_img_raw(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        sh, sw = (h - 1024) // 2, (w - 1280) // 2
        return img[sh : sh + 1024, sw : sw + 1280]

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

        imgs, intr_list, extr_list = [], [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            if not self.use_raw_train:
                img_path = os.path.join(
                    self.datapath,
                    f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light_idx}_r5000.png",
                )
            else:
                img_path = os.path.join(
                    self.datapath,
                    f"Rectified_raw/{scan}/rect_{vid + 1:0>3}_{light_idx}_r5000.png",
                )
            cam_path = os.path.join(self.datapath, f"Cameras/train/{vid:0>8}_cam.txt")

            img = read_image(img_path)
            if self.mode == "train":
                img = color_jitter(rng, img, brightness=0.5, contrast=0.5)
            if self.use_raw_train:
                img = self._crop_img_raw(img)

            intrinsics, extrinsics, dmin, ditv, _ = read_cam_file(cam_path)
            ditv *= self.interval_scale
            extrinsics = extrinsics.copy()
            if self.rt:
                extrinsics[:3, 3] *= scale
            if self.use_raw_train:
                intrinsics = intrinsics.copy()
                intrinsics[:2, :] *= 2.0

            if i == 0:
                mask_hr = (
                    np.array(
                        read_image(
                            os.path.join(
                                self.datapath,
                                f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png",
                            )
                        )[..., 0]
                        * 255.0
                    )
                    > 10
                ).astype(np.float32)
                depth_hr = read_pfm(
                    os.path.join(
                        self.datapath, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm"
                    )
                )[0].astype(np.float32) * scale
                mask_ms = pyramid_nearest(self._crop_hr(mask_hr))
                depth_ms = pyramid_nearest(self._crop_hr(depth_hr))
                dmax = ditv * self.NDEPTHS + dmin
                depth_values = np.array([dmin * scale, dmax * scale], dtype=np.float32)

            imgs.append(img)
            intr_list.append(intrinsics)
            extr_list.append(extrinsics)

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_pyramid(intr_list, extr_list, base_stage=2),
            "depth": depth_ms,
            "depth_values": depth_values,
            "mask": mask_ms,
        }
