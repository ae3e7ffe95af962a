"""BlendedMVS train/val dataset (reference datasets/blendedmvs.py).

The port's copy of the JAX package's ``data/blendedmvs.py`` (numpy only;
Pillow and OpenCV are imported inside the functions that use them).

Layout: {scan}/blended_images/{vid:08d}.jpg, {scan}/rendered_depth_maps/
{vid:08d}.pfm, {scan}/cams/{vid:08d}_cam.txt + cams/pair.txt.

Behavioural parity:
- per-scan depth normalization ``100 / depth_min`` applied to the extrinsics
  translation, depth maps and the range (blendedmvs.py:73-79);
- mask = depth within [min, max] (blendedmvs.py:88-90);
- cams are full-res for the 768x576 images; stages built from 1/8 upward
  (blendedmvs.py:157-194) => base_stage=4;
- metas keep only pairs with >= nviews-1 sources (blendedmvs.py:59-60).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .base import proj_pyramid, robust_view_selection, sample_rng
from .io import pyramid_nearest, read_image, read_pair_file, read_pfm, read_scan_list, resize_nearest


class BlendedMVSDataset:
    def __init__(
        self,
        datapath: str,
        listfile: str,
        mode: str,
        nviews: int,
        *,
        img_wh=(768, 576),
        robust_train: bool = True,
        pair_fname: str = "pair.txt",   # accepted for CLI parity; unused
        Nlights: str = "1:1",           # accepted for CLI parity; unused
        seed: int = 0,
    ):
        assert mode in ("train", "val", "all")
        if img_wh is not None:
            assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.img_wh = img_wh
        self.robust_train = robust_train
        self.seed = seed
        self.epoch = 0
        self.scale_factors: Dict[str, float] = {}
        self.metas = []
        for scan in read_scan_list(listfile):
            pairs = read_pair_file(os.path.join(datapath, scan, "cams/pair.txt"))
            for ref_view, src_views in pairs:
                if len(src_views) >= nviews - 1:
                    self.metas.append((scan, ref_view, src_views))

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, scan: str, path: str):
        from .io import read_cam_file

        intrinsics, extrinsics, dmin, _, fields = read_cam_file(path)
        dmax = fields[-1]  # explicit max, 4th field (blendedmvs.py:70-71)
        if scan not in self.scale_factors:
            self.scale_factors[scan] = 100.0 / dmin
        sf = self.scale_factors[scan]
        extrinsics = extrinsics.copy()
        extrinsics[:3, 3] *= sf
        return intrinsics, extrinsics, dmin * sf, dmax * sf

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __getitem__(self, idx: int) -> Dict:
        scan, ref_view, src_views = self.metas[idx]
        if self.robust_train:
            view_ids, scale = robust_view_selection(
                sample_rng(self.seed, self.epoch, idx), ref_view, src_views, self.nviews
            )
        else:
            view_ids = [ref_view] + src_views[: self.nviews - 1]
            scale = 1.0

        imgs, intr_list, extr_list = [], [], []
        depth_ms = mask_ms = None
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img = read_image(
                os.path.join(self.datapath, f"{scan}/blended_images/{vid:0>8}.jpg")
            )
            if self.img_wh is not None and img.shape[:2][::-1] != tuple(self.img_wh):
                import cv2

                img = cv2.resize(img, tuple(self.img_wh), interpolation=cv2.INTER_LINEAR)
            imgs.append(img)

            intrinsics, extrinsics, dmin, dmax = self._read_cam(
                scan, os.path.join(self.datapath, f"{scan}/cams/{vid:0>8}_cam.txt")
            )
            extrinsics = extrinsics.copy()
            extrinsics[:3, 3] *= scale
            intr_list.append(intrinsics)
            extr_list.append(extrinsics)

            if i == 0:
                depth_min, depth_max = dmin * scale, dmax * scale
                depth = read_pfm(
                    os.path.join(
                        self.datapath, f"{scan}/rendered_depth_maps/{vid:0>8}.pfm"
                    )
                )[0].astype(np.float32)
                depth = depth * self.scale_factors[scan] * scale
                mask = ((depth >= depth_min) & (depth <= depth_max)).astype(np.float32)
                if self.img_wh is not None:
                    depth = resize_nearest(depth, tuple(self.img_wh))
                    mask = resize_nearest(mask, tuple(self.img_wh))
                depth_ms = pyramid_nearest(depth)
                mask_ms = pyramid_nearest(mask)

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_pyramid(intr_list, extr_list, base_stage=4),
            "depth": depth_ms,
            "depth_values": np.array([depth_min, depth_max], dtype=np.float32),
            "mask": mask_ms,
        }
