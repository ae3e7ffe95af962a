"""Shared dataset machinery: projection-matrix pyramids, per-sample random
generators and augmentation.

The port's copy of the JAX package's ``data/base.py`` (numpy only; OpenCV
is imported inside ``color_jitter``'s hue step). Sample spec (the reference
loaders', ``datasets/dtu_yao4.py:228-232``, NHWC and views stacked):

  imgs            [V, H, W, 3]  float32 in [0, 1]
  proj_matrices   {"stage1".."stage4"}: [V, 2, 4, 4]  (extrinsics, intrinsics)
  depth           {"stage1".."stage4"}: [h, w]        (train only)
  depth_values    [2] (train: min/max) or [D] (eval: all hypothesis planes)
  mask            {"stage1".."stage4"}: [h, w]        (train only)
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def stack_proj_stage(intrinsics: Sequence[np.ndarray],
                     extrinsics: Sequence[np.ndarray],
                     scale: float) -> np.ndarray:
    """[V, 2, 4, 4] stack with intrinsics rows 0-1 scaled by ``scale``."""
    V = len(intrinsics)
    out = np.zeros((V, 2, 4, 4), dtype=np.float32)
    for v in range(V):
        out[v, 0] = extrinsics[v]
        K = intrinsics[v].copy()
        K[:2, :] *= scale
        out[v, 1, :3, :3] = K
    return out


def proj_pyramid(intrinsics, extrinsics, base_stage: int) -> Dict[str, np.ndarray]:
    """Multi-scale projection dict from per-view (K, E) given at the
    resolution of ``base_stage``.

    - DTU train cams are quarter-res => base_stage=2 (stage1 = K/2,
      stage3 = K*2, stage4 = K*4 — reference dtu_yao4.py:212-225);
    - Blender / eval cams are full-res => base_stage=4 (stage1 = K/8 ... —
      reference blender4.py:217-231, dataloader_eval.py:280-294).
    """
    return {
        f"stage{s}": stack_proj_stage(intrinsics, extrinsics, 2.0 ** (s - base_stage))
        for s in (1, 2, 3, 4)
    }


def sample_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """Per-sample RNG derived from ``(seed, epoch, idx)``.

    Datasets must NOT share one ``np.random.Generator`` across
    ``__getitem__`` calls: the DataLoader maps ``__getitem__`` over a thread
    pool and ``numpy.random.Generator`` is not thread-safe — concurrent draws
    can corrupt generator state, and even when they don't, the augmentation
    stream depends on thread scheduling. A generator keyed on the sample
    index makes augmentation reproducible for any ``num_workers``.
    """
    return np.random.default_rng(np.random.SeedSequence((seed, epoch, idx)))


# ------------------------------------------------------- augmentation --------

def color_jitter(
    rng: np.random.Generator,
    img: np.ndarray,
    *,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> np.ndarray:
    """torchvision-ColorJitter-style augmentation on a float [0,1] RGB image
    (random factor per property, random application order).

    Matches the semantics the reference relies on (dtu_yao4.py:24 jitter
    brightness/contrast 0.5; blender4.py:23 adds saturation 0.4, hue 0.01).
    """
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(("b", f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(("c", f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(("s", f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(("h", f))
    rng.shuffle(ops)

    lum_w = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    for kind, f in ops:
        if kind == "b":
            img = img * f
        elif kind == "c":
            mean = (img @ lum_w).mean()
            img = (img - mean) * f + mean
        elif kind == "s":
            gray = (img @ lum_w)[..., None]
            img = (img - gray) * f + gray
        elif kind == "h":
            import cv2

            hsv = cv2.cvtColor(
                np.clip(img, 0, 1).astype(np.float32), cv2.COLOR_RGB2HSV
            )
            hsv[..., 0] = (hsv[..., 0] + f * 360.0) % 360.0
            img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        img = np.clip(img, 0.0, 1.0)
    return img.astype(np.float32)


def robust_view_selection(
    rng: np.random.Generator, ref_view: int, src_views: Sequence[int], nviews: int
):
    """Robust-training view sampling + depth/translation scale in [0.8, 1.25]
    (reference dtu_yao4.py:138-145)."""
    idx = rng.choice(len(src_views), size=nviews - 1, replace=False)
    view_ids = [ref_view] + [src_views[i] for i in idx]
    scale = float(rng.uniform(0.8, 1.25))
    return view_ids, scale
