"""Tanks&Temples eval dataset (reference datasets/tanks.py).

The port's copy of the JAX package's ``data/tanks.py`` (numpy only).

Intermediate/advanced splits with the reference's hard-coded scan lists;
1080 -> 1024 vertical crop (28 px top/bottom) with principal-point shift
(tanks.py:53-60); full-res cams => base_stage=4; depth_values = [min, max]
from the cam file's first/last depth fields.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .base import proj_pyramid
from .io import read_cam_file, read_image, read_pair_file

INTERMEDIATE = (
    "Family", "Francis", "Horse", "Playground", "Train", "Lighthouse", "M60",
    "Panther",
)
ADVANCED = ("Auditorium", "Ballroom", "Courtroom", "Museum", "Palace", "Temple")


class TanksDataset:
    def __init__(self, datapath: str, n_views: int = 7, split: str = "intermediate"):
        assert split in ("intermediate", "advanced")
        self.datapath = datapath
        self.split = split
        self.n_views = n_views
        self.scans = INTERMEDIATE if split == "intermediate" else ADVANCED
        self.metas = []
        for scan in self.scans:
            pairs = read_pair_file(os.path.join(datapath, split, scan, "pair.txt"))
            for ref_view, src_views in pairs:
                self.metas.append((scan, ref_view, src_views))

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict:
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.n_views - 1]

        imgs, intr_list, extr_list = [], [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            base = os.path.join(self.datapath, self.split, scan)
            img = read_image(os.path.join(base, f"images/{vid:08d}.jpg"))
            intrinsics, extrinsics, dmin, _, fields = read_cam_file(
                os.path.join(base, f"cams/{vid:08d}_cam.txt")
            )
            # 1080 -> 1024 vertical crop (tanks.py:53-60)
            intrinsics = intrinsics.copy()
            intrinsics[1, 2] -= 28
            img = img[28 : 1080 - 28, :, :]
            imgs.append(img)
            intr_list.append(intrinsics)
            extr_list.append(extrinsics)
            if i == 0:
                depth_min, depth_max = dmin, fields[-1]

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_pyramid(intr_list, extr_list, base_stage=4),
            "depth_values": np.array([depth_min, depth_max], dtype=np.float32),
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
