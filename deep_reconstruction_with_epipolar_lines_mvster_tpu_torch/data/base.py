"""Projection-matrix pyramids of the sample spec.

The port's copy of ``stack_proj_stage`` and ``proj_pyramid`` from the JAX
package's ``data/base.py`` (numpy only). Sample spec (the reference
loaders', ``datasets/dtu_yao4.py:228-232``, NHWC and views stacked):

  imgs            [V, H, W, 3]  float32 in [0, 1]
  proj_matrices   {"stage1".."stage4"}: [V, 2, 4, 4]  (extrinsics, intrinsics)
  depth_values    [2] (train: min/max) or [D] (eval: all hypothesis planes)
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
