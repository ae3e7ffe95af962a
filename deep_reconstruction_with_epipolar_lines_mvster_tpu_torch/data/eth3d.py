"""ETH3D eval dataset (reference datasets/eth3d.py).

The port's copy of the JAX package's ``data/eth3d.py`` (numpy only;
OpenCV is imported inside ``__getitem__``, which resizes).

Hard-coded train/test scan lists; images resized to ``img_wh`` (default
1920x1280) with intrinsics scaling (eth3d.py:57-63,90-92); negative
depth_min clamped to 1 (eth3d.py:50-52); full-res cams => base_stage=4.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .base import proj_pyramid
from .io import read_cam_file, read_image, read_pair_file

TEST_SCANS = (
    "botanical_garden", "boulders", "bridge", "door", "exhibition_hall",
    "lecture_room", "living_room", "lounge", "observatory", "old_computer",
    "statue", "terrace_2",
)
TRAIN_SCANS = (
    "courtyard", "delivery_area", "electro", "facade", "kicker", "meadow",
    "office", "pipes", "playground", "relief", "relief_2", "terrace",
    "terrains",
)


class ETH3DDataset:
    def __init__(self, datapath: str, split: str = "test", n_views: int = 7,
                 img_wh=(1920, 1280)):
        assert split in ("test", "train")
        self.datapath = datapath
        self.n_views = n_views
        self.img_wh = img_wh
        self.scans = TEST_SCANS if split == "test" else TRAIN_SCANS
        self.metas = []
        for scan in self.scans:
            pairs = read_pair_file(os.path.join(datapath, scan, "pair.txt"))
            for ref_view, src_views in pairs:
                self.metas.append((scan, ref_view, src_views))

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict:
        import cv2

        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.n_views - 1]

        imgs, intr_list, extr_list = [], [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img = read_image(os.path.join(self.datapath, scan, f"images/{vid:08d}.jpg"))
            oh, ow = img.shape[:2]
            img = cv2.resize(img, tuple(self.img_wh), interpolation=cv2.INTER_LINEAR)
            intrinsics, extrinsics, dmin, _, fields = read_cam_file(
                os.path.join(self.datapath, scan, f"cams_1/{vid:08d}_cam.txt")
            )
            intrinsics = intrinsics.copy()
            intrinsics[0] *= self.img_wh[0] / ow
            intrinsics[1] *= self.img_wh[1] / oh
            imgs.append(img)
            intr_list.append(intrinsics)
            extr_list.append(extrinsics)
            if i == 0:
                depth_min = max(dmin, 1.0) if dmin < 0 else dmin
                depth_max = fields[-1]

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_pyramid(intr_list, extr_list, base_stage=4),
            "depth_values": np.array([depth_min, depth_max], dtype=np.float32),
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
