"""Headless scene-visualization helpers.

The port's copy of the JAX package's ``eval/viz.py`` (numpy, and
scipy's ``cKDTree`` for the outlier removal).

The reference's eval debug path builds Open3D bin bounding boxes with
per-rig presets and camera-pose arrow glyphs for interactive windows
(``test_mvs4.py:233-326``). Eval jobs run headless, so the same observables
are produced as *geometry* — corner/edge point sets written alongside the
fused cloud — viewable in any cloud viewer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# per-rig bin-geometry presets keyed on dataset-path substrings
# (reference get_o3d_frame_bbox, test_mvs4.py:243-259); dims in meters
RIG_PRESETS = {
    "overhead03": dict(dims=(0.57, 0.37, 0.22), delta=(0.08, 0.03, 0.0)),
    "overhead02": dict(dims=(0.57, 0.37, 0.22), delta=(0.08, 0.03, 0.0)),
    "Merlin_Mario_Set_with_GT": dict(dims=(0.57, 0.37, 0.22), delta=(0.125, 0.09, 0.0)),
}
DEFAULT_PRESET = dict(dims=(0.57, 0.37, 0.22), delta=(0.0, 0.0, 0.0))


def bin_bbox_bounds(
    context: Optional[str] = None,
    *,
    dims: Tuple[float, float, float] = (0.57, 0.37, 0.22),
    delta: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale: float = 1.0,
    wall_mm: float = 20.0,
):
    """(inner_min, inner_max, outer_min, outer_max) in mm — the reference's
    bin inner/outer wall boxes (test_mvs4.py:264-289)."""
    if context is not None:
        preset = DEFAULT_PRESET
        for key, p in RIG_PRESETS.items():
            if key in context:
                preset = p
                break
        dims, delta = preset["dims"], preset["delta"]
    dims_mm = np.asarray(dims) * 1000.0 * scale
    delta_mm = np.asarray(delta) * 1000.0 * scale
    mn = -dims_mm / 2.0
    mx = dims_mm / 2.0
    mx[2] -= mn[2]
    mn[2] = 0.0
    inner_min, inner_max = mn + delta_mm, mx + delta_mm
    outer_min = inner_min - wall_mm
    outer_max = inner_max + np.array([wall_mm, wall_mm, 0.0])
    return inner_min, inner_max, outer_min, outer_max


def bbox_edge_points(mn: np.ndarray, mx: np.ndarray, n_per_edge: int = 20) -> np.ndarray:
    """Point samples along the 12 edges of an axis-aligned box."""
    mn, mx = np.asarray(mn, float), np.asarray(mx, float)
    ts = np.linspace(0.0, 1.0, n_per_edge)
    pts = []
    corners = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    for i, ca in enumerate(corners):
        for cb in corners[i + 1 :]:
            if sum(x != y for x, y in zip(ca, cb)) == 1:  # share an edge
                a = np.where(ca, mx, mn)
                b = np.where(cb, mx, mn)
                pts.append(a[None] + ts[:, None] * (b - a)[None])
    return np.concatenate(pts, axis=0)


def camera_glyph_points(
    extrinsics: Sequence[np.ndarray], length: float = 30.0, n: int = 15
) -> np.ndarray:
    """Camera positions with a viewing-direction tail per camera (the arrow
    glyphs of test_mvs4.py:303-326, as points)."""
    pts = []
    for E in extrinsics:
        E = np.asarray(E, float)
        R, t = E[:3, :3], E[:3, 3]
        center = -R.T @ t
        direction = R.T @ np.array([0.0, 0.0, 1.0])
        ts = np.linspace(0.0, length, n)
        pts.append(center[None] - ts[:, None] * direction[None])
    return np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))


def crop_to_box(xyz: np.ndarray, mn, mx) -> np.ndarray:
    """Axis-aligned crop (the reference's pcd.crop(bbox2),
    test_mvs4.py:875)."""
    m = np.all((xyz >= np.asarray(mn)) & (xyz <= np.asarray(mx)), axis=1)
    return xyz[m]


def remove_statistical_outliers(
    xyz: np.ndarray, nb_neighbors: int = 15, std_ratio: float = 2.0
) -> np.ndarray:
    """Statistical outlier removal (the reference's
    remove_statistical_outlier, test_mvs4.py:878): drop points whose mean
    k-NN distance exceeds mean + std_ratio * std."""
    if len(xyz) <= nb_neighbors:
        return xyz
    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    d, _ = tree.query(xyz, k=nb_neighbors + 1, workers=-1)
    mean_d = d[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return xyz[mean_d <= thresh]


def voxel_downsample(xyz: np.ndarray, voxel: float) -> np.ndarray:
    """Voxel-grid downsample: centroid per occupied voxel (the reference's
    voxel_down_sample, test_mvs4.py:888)."""
    if len(xyz) == 0:
        return xyz
    keys = np.floor(xyz / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), dtype=np.float64)
    np.add.at(sums, inv, xyz)
    return (sums / counts[:, None]).astype(np.float32)
