"""Unified eval/reconstruction dataset (reference datasets/dataloader_eval.py).

The port's copy of the JAX package's ``data/eval_loader.py`` (numpy only;
OpenCV is imported inside ``rescale_crop_image``).

``dsname`` selects the folder/filename templates (dtu / blender / bin,
reference :30-43). Per view: read cam, rescale the image down to fit
(max_h, max_w), scale intrinsics, then center-crop so final dims are
multiples of 64 (base_image_size, reference read_rescale_crop_img :94-171),
adjusting the principal point. depth_values carries all 192 uniform
hypothesis planes (reference :275); the sample includes the ``filename``
routing template ``"{scan}/{}/0000000X{}"`` used by the artifact writer.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import numpy as np

from .base import proj_pyramid
from .io import read_cam_file, read_pair_file


BASE_IMAGE_SIZE = 64


def rescale_crop_image(
    img: np.ndarray, intrinsics: np.ndarray, target_hw
) -> tuple[np.ndarray, np.ndarray]:
    """Rescale-to-fit + center-crop-to-64-multiple with intrinsics tracking.

    Pure function so it is unit-testable against the reference formulas
    (dataloader_eval.py:94-171). ``img`` float [0,1] HxWx3.
    """
    import cv2

    h_src, w_src = img.shape[:2]
    h_t, w_t = target_hw
    h_scale = h_t / h_src
    w_scale = w_t / w_src
    if h_scale > 1 or w_scale > 1:
        raise ValueError("image resolution should only be reduced")
    resize_scale = max(h_scale, w_scale)
    new_w, new_h = int(w_src * resize_scale), int(h_src * resize_scale)
    img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    intrinsics = intrinsics.copy()
    intrinsics[:2, :] *= resize_scale

    final_h = h_t if new_h > h_t else int(math.floor(h_t / BASE_IMAGE_SIZE) * BASE_IMAGE_SIZE)
    final_w = w_t if new_w > w_t else int(math.floor(w_t / BASE_IMAGE_SIZE) * BASE_IMAGE_SIZE)
    start_h = int(math.floor((new_h - final_h) / 2))
    start_w = int(math.floor((new_w - final_w) / 2))
    img = img[start_h : start_h + final_h, start_w : start_w + final_w]
    intrinsics[0, 2] -= start_w
    intrinsics[1, 2] -= start_h
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return np.ascontiguousarray(img.astype(np.float32)), intrinsics


class EvalDataset:
    NDEPTHS = 192

    def __init__(
        self,
        datapath: str,
        resolution: str,
        listfile: Sequence[str],
        mode: str,
        nviews: int,
        interval_scale: float = 1.06,
        *,
        max_h: int = 512,
        max_w: int = 640,
        pair_fname: str = "pair.txt",
        lighting: int = 3,
        dsname: str = "blender",
    ):
        assert mode == "test"
        self.datapath = datapath
        self.resolution = resolution
        self.nviews = nviews
        self.interval_scale = interval_scale
        self.max_h, self.max_w = max_h, max_w
        self.lighting = lighting
        self.dsname = dsname

        if dsname == "dtu":
            self.pair_path = os.path.join(datapath, pair_fname)
            self.img_tpl = "Rectified_raw/{}/rect_{:0>3}_3_r5000.png"
            self.cam_tpl = "Cameras/{:0>8}_cam.txt"
        elif dsname == "blender":
            self.pair_path = os.path.join(datapath, pair_fname)
            self.img_tpl = "Rectified" + resolution + "/{}/rect_C{:0>3}_L{:0>2}.png"
            self.cam_tpl = "Cameras" + resolution + "/{:0>8}_cam.txt"
        elif dsname == "bin":
            self.pair_path = os.path.join(datapath, "../..", pair_fname)
            self.img_tpl = "Rectified/{}/{:0>8}.png"
            self.cam_tpl = "Cameras/{:0>8}_cam.txt"
        else:
            raise ValueError(f"unknown dsname {dsname!r}")

        self.metas: List = []
        pairs = read_pair_file(self.pair_path)
        for scan in listfile:
            for ref_view, src_views in pairs:
                self.metas.append((scan, ref_view, src_views))

    def __len__(self):
        return len(self.metas)

    def _img_path(self, scan: str, vid: int) -> str:
        if self.dsname == "dtu":
            return os.path.join(self.datapath, self.img_tpl.format(scan, vid + 1))
        if self.dsname == "blender":
            return os.path.join(
                self.datapath, self.img_tpl.format(scan, vid, self.lighting)
            )
        return os.path.join(self.datapath, self.img_tpl.format(scan, vid))

    def __getitem__(self, idx: int) -> Dict:
        from .io import read_image

        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, intr_list, extr_list = [], [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            intrinsics, extrinsics, dmin, ditv, fields = read_cam_file(
                os.path.join(self.datapath, self.cam_tpl.format(vid))
            )
            if len(fields) >= 3:
                # 3+-field cam line: respread the interval over NDEPTHS
                # (dataloader_eval.py:81-84)
                dmax = dmin + fields[2] * ditv
                ditv = (dmax - dmin) / self.NDEPTHS
            ditv *= self.interval_scale

            img, intrinsics = rescale_crop_image(
                read_image(self._img_path(scan, vid)),
                intrinsics,
                (self.max_h, self.max_w),
            )
            imgs.append(img)
            intr_list.append(intrinsics)
            extr_list.append(extrinsics)
            if i == 0:
                # uniform 192 hypothesis planes (dataloader_eval.py:275)
                depth_values = np.arange(
                    dmin, ditv * (self.NDEPTHS - 0.5) + dmin, ditv, dtype=np.float32
                )

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_pyramid(intr_list, extr_list, base_stage=4),
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
