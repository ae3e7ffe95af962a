"""File-format IO: PFM depth maps, MVSNet cam txt, pair files, images.

The port's copy of the JAX package's ``data/io.py`` (numpy only; Pillow
and OpenCV are imported inside the functions that use them).

Format parity with the reference (``datasets/data_io.py:6-71``,
``datasets/dtu_yao4.py:60-71``, ``test_mvs4.py:143-204``):

- PFM: 'Pf'/'PF' header, width height, negative scale = little-endian,
  rows stored bottom-up (vertical flip on read/write);
- cam txt: 'extrinsic' 4x4 on lines 1-4, 'intrinsic' 3x3 on lines 7-9,
  line 11 = ``depth_min depth_interval [num_depth depth_max]``;
- pair txt: count, then per ref view an id line and a scored src-view line
  parsed ``[1::2]``.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------- PFM --------

def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dim_line = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype.name != "float32":
        raise ValueError("PFM image dtype must be float32")
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


# ---------------------------------------------------------- cam files --------

def read_cam_file(path: str) -> Tuple[np.ndarray, np.ndarray, float, float, Tuple[float, ...]]:
    """Returns (intrinsics 3x3, extrinsics 4x4, depth_min, depth_interval,
    raw_depth_fields). ``raw_depth_fields`` is the full tuple of floats on
    line 11 — 2 fields for train cams, up to 4
    (``min interval num_depth max``) for eval/BlendedMVS cams
    (dataloader_eval.py:81-84, blendedmvs.py:70-71)."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    fields = tuple(float(x) for x in lines[11].split())
    return intrinsics, extrinsics, fields[0], fields[1], fields


def write_cam_file(path: str, extrinsics: np.ndarray, intrinsics: np.ndarray,
                   depth_line: Sequence[float]) -> None:
    """Write the reference cam txt layout (test_mvs4.py:187-204)."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsics).reshape(4, 4):
            f.write(" ".join(str(v) for v in row) + " \n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsics).reshape(3, 3)[:3, :3]:
            f.write(" ".join(str(v) for v in row) + " \n")
        f.write("\n" + " ".join(str(v) for v in depth_line) + "\n")


# ---------------------------------------------------------- pair files -------

def read_pair_file(path: str) -> List[Tuple[int, List[int]]]:
    data = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if len(src_views) > 0:
                data.append((ref_view, src_views))
    return data


def write_pair_file(path: str, pairs: Sequence[Tuple[int, Sequence[int]]]) -> None:
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n")
            f.write(f"{len(srcs)} " + " ".join(f"{s} 1.0" for s in srcs) + "\n")


# ------------------------------------------------------------- images --------

def read_image(path: str) -> np.ndarray:
    """Image file -> float32 RGB in [0, 1], shape [H, W, 3]."""
    from PIL import Image

    img = np.array(Image.open(path), dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


def save_image_u8(path: str, img01: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def read_scan_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip() for line in f if line.strip()]


# ----------------------------------------------------------- resizing --------

def resize_nearest(arr: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """cv2 INTER_NEAREST resize (the reference's pyramid downsampler)."""
    import cv2

    return cv2.resize(arr, wh, interpolation=cv2.INTER_NEAREST)


def pyramid_nearest(arr: np.ndarray, num_stages: int = 4) -> dict:
    """{stage1: 1/8, stage2: 1/4, stage3: 1/2, stage4: full} nearest pyramid
    (reference dtu_yao4.py:101-131)."""
    h, w = arr.shape[:2]
    out = {f"stage{num_stages}": arr}
    for i in range(1, num_stages):
        s = 2 ** (num_stages - i)
        out[f"stage{i}"] = resize_nearest(arr, (w // s, h // s))
    return out
