"""Point-cloud accuracy / completeness metrics (DTU-style).

The port's copy of the JAX package's ``eval/pcd_metrics.py`` (numpy,
and scipy's ``cKDTree`` for the nearest neighbours).

The reference defers DTU benchmark numbers to an external MATLAB toolkit via
a vestigial hook with a hard-coded upstream path (``test_mvs4.py:929-935``).
This module implements the standard metric in-repo so reconstructions can be
scored end-to-end:

- **accuracy**: for each predicted point, distance to the nearest GT point;
  reported as the mean over the best ``percentile``% (the DTU convention
  discards outliers above a max distance);
- **completeness**: for each GT point, distance to the nearest predicted
  point, same filtering;
- **overall** = (accuracy + completeness) / 2;
- threshold variants: fraction of points within ``tau``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _nn_dists(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(dst, dtype=np.float64))
    d, _ = tree.query(np.asarray(src, dtype=np.float64), k=1, workers=-1)
    return d.astype(np.float64)


def accuracy_completeness(
    pred_xyz: np.ndarray,
    gt_xyz: np.ndarray,
    *,
    max_dist: Optional[float] = None,
    tau: float = 2.0,
    sample: Optional[int] = 500_000,
    seed: int = 0,
) -> Dict[str, float]:
    """DTU-style cloud comparison.

    Args:
      pred_xyz / gt_xyz: [N, 3] point clouds (same units, e.g. mm).
      max_dist: discard distances above this before averaging (DTU uses 20mm);
        None keeps everything.
      tau: threshold for the precision/recall style fractions.
      sample: subsample each cloud to at most this many points for tractable
        KD queries (deterministic).
    """
    rng = np.random.default_rng(seed)

    def sub(x):
        if sample is not None and len(x) > sample:
            return x[rng.choice(len(x), sample, replace=False)]
        return x

    pred = sub(np.asarray(pred_xyz, dtype=np.float64))
    gt = sub(np.asarray(gt_xyz, dtype=np.float64))
    if len(pred) == 0 or len(gt) == 0:
        return {
            "accuracy": float("inf"), "completeness": float("inf"),
            "overall": float("inf"), f"precision@{tau}": 0.0,
            f"recall@{tau}": 0.0, "f1": 0.0,
        }

    d_acc = _nn_dists(pred, gt)
    d_comp = _nn_dists(gt, pred)
    if max_dist is not None:
        acc = float(d_acc[d_acc <= max_dist].mean()) if (d_acc <= max_dist).any() else float("inf")
        comp = float(d_comp[d_comp <= max_dist].mean()) if (d_comp <= max_dist).any() else float("inf")
    else:
        acc = float(d_acc.mean())
        comp = float(d_comp.mean())
    prec = float((d_acc <= tau).mean())
    rec = float((d_comp <= tau).mean())
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return {
        "accuracy": acc,
        "completeness": comp,
        "overall": (acc + comp) / 2.0,
        f"precision@{tau}": prec,
        f"recall@{tau}": rec,
        "f1": f1,
    }
