"""Synthetic multi-view fixture: an analytically rendered textured plane.

A numpy copy of the JAX package's ``data/synthetic.py`` (the scene, the
eval dataset over it and ``SyntheticTrainDataset``, behind the train CLI's
zero-file ``--dataset synthetic``), so that the port's tests,
``chip_smoke.py`` and the train CLI build the same inputs without importing
that package. The sample dict follows the reference loader spec
(``datasets/dtu_yao4.py:228-232``): ``imgs [V,H,W,3]``, ``proj_matrices
{stage: [V,2,4,4]}``, ``depth {stage: [h,w]}``, ``depth_values [2]``,
``mask {stage: [h,w]}``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth but feature-rich RGB texture over world (X, Y)."""
    r = 0.5 + 0.5 * np.sin(0.37 * x) * np.cos(0.23 * y)
    g = 0.5 + 0.5 * np.sin(0.11 * x + 1.3) * np.sin(0.31 * y + 0.7)
    b = 0.5 + 0.25 * np.cos(0.19 * x * y / 50.0) + 0.25 * np.sin(0.41 * y)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def make_plane_scene(
    V: int = 3,
    H: int = 64,
    W: int = 64,
    *,
    z0: float = 600.0,
    gx: float = 0.15,
    gy: float = -0.1,
    baseline: float = 12.0,
    depth_range: tuple = (425.0, 935.0),
    num_stages: int = 4,
    seed: int = 0,
) -> Dict:
    """Render the plane ``Z = z0 + gx·X + gy·Y`` (world == ref camera frame),
    seen by V translated copies of the reference camera spaced ``baseline``
    apart along x with a slight y jitter."""
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], dtype=np.float32)
    n = np.array([-gx, -gy, 1.0], dtype=np.float64)

    extrinsics = []
    for v in range(V):
        E = np.eye(4, dtype=np.float32)
        if v > 0:
            E[0, 3] = -baseline * v
            E[1, 3] = float(rng.uniform(-0.2, 0.2) * baseline)
        extrinsics.append(E)

    imgs = []
    view_depths = []
    for v in range(V):
        E = extrinsics[v].astype(np.float64)
        R = E[:3, :3]
        t = E[:3, 3]
        C = -R.T @ t
        xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
        pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
        d_cam = pix @ np.linalg.inv(K).T.astype(np.float64)
        d_world = d_cam @ R
        s = (z0 - n @ C) / (d_world @ n)
        P = C[None, None, :] + s[..., None] * d_world
        imgs.append(_texture(P[..., 0], P[..., 1]))
        view_depths.append((P @ R.T[:, 2] + t[2]).astype(np.float32))
    imgs = np.stack(imgs).astype(np.float32)

    def depth_at(h, w):
        scale = np.array([w / W, h / H], dtype=np.float64)
        Ks = K.astype(np.float64).copy()
        Ks[0] *= scale[0]
        Ks[1] *= scale[1]
        xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
        pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
        d_cam = pix @ np.linalg.inv(Ks).T
        s = z0 / (d_cam @ n)
        return (s * d_cam[..., 2]).astype(np.float32)

    depth_ms, mask_ms, projs = {}, {}, {}
    for st in range(num_stages):
        scale = 2.0 ** (st - (num_stages - 1))  # stage4 = full res
        h, w = int(H * scale), int(W * scale)
        depth_ms[f"stage{st + 1}"] = depth_at(h, w)
        mask_ms[f"stage{st + 1}"] = np.ones((h, w), dtype=np.float32)
        stacks = np.zeros((V, 2, 4, 4), dtype=np.float32)
        for v in range(V):
            stacks[v, 0] = extrinsics[v]
            Ks = K.copy()
            Ks[:2] *= scale
            stacks[v, 1, :3, :3] = Ks
        projs[f"stage{st + 1}"] = stacks

    return {
        "imgs": imgs,
        "proj_matrices": projs,
        "depth": depth_ms,
        "depth_values": np.array(depth_range, dtype=np.float32),
        "mask": mask_ms,
        "view_depths": np.stack(view_depths),
        "intrinsics": K,
        "extrinsics": np.stack(extrinsics),
    }


class SyntheticEvalDataset:
    """Eval-style dataset over the plane scene: one sample per reference view
    (each view takes a turn as ref), mirroring the unified eval loader's
    sample spec incl. the ``filename`` routing template and 192 uniform
    depth hypotheses (dataloader_eval.py:275,304-307). ``pairs`` lists
    ``(ref_view, src_views)`` per sample, as a pair file does: the other
    views in order."""

    NDEPTHS = 192

    def __init__(self, V: int = 3, H: int = 64, W: int = 64, scan: str = "scan1",
                 **scene_kwargs):
        self.scene = make_plane_scene(V=V, H=H, W=W, **scene_kwargs)
        self.V = V
        self.scan = scan
        self.pairs = [(v, [s for s in range(V) if s != v]) for v in range(V)]

    def __len__(self):
        return self.V

    def __getitem__(self, idx: int) -> Dict:
        sc = self.scene
        ref, srcs = self.pairs[idx]
        order = [ref] + srcs
        imgs = sc["imgs"][order]
        projs = {k: v[order] for k, v in sc["proj_matrices"].items()}
        dmin, dmax = sc["depth_values"]
        itv = (dmax - dmin) / self.NDEPTHS
        depth_values = np.arange(
            dmin, itv * (self.NDEPTHS - 0.5) + dmin, itv, dtype=np.float32
        )
        return {
            "imgs": imgs.astype(np.float32),
            "proj_matrices": projs,
            "depth_values": depth_values,
            "filename": self.scan + "/{}/" + f"{idx:0>8}" + "{}",
        }


class SyntheticTrainDataset:
    """Train-style dataset over analytic plane scenes, constructor-compatible
    with the CLI dataset protocol (``DS(datapath, listfile, mode, nviews,
    interval_scale, **common)`` — cli/train.py) so the full train CLI can run
    with zero data files: ``--dataset synthetic --trainpath 'synthetic://HxW/N'``
    (default ``64x64/8``). ``listfile`` is ignored.

    Each index is its own deterministic plane scene (seeded by ``(seed, idx)``,
    independent of epoch/workers), with slightly varying slants so batches are
    not degenerate.
    """

    def __init__(self, datapath, listfile, mode, nviews, interval_scale=1.0,
                 *, rt=False, use_raw_train=False, pair_fname="pair.txt",
                 Nlights="", seed=0, **_ignored):
        h, w, n = 64, 64, 8
        if datapath and str(datapath).startswith("synthetic://"):
            spec = str(datapath)[len("synthetic://"):]
            size, _, count = spec.partition("/")
            if "x" in size:
                h, w = (int(x) for x in size.split("x"))
            if count:
                n = int(count)
        self.H, self.W, self.n = h, w, n
        self.mode = mode
        self.nviews = nviews
        self.seed = seed

    def __len__(self):
        return self.n

    def set_epoch(self, epoch: int) -> None:
        pass  # scenes are index-deterministic

    def __getitem__(self, idx: int) -> Dict:
        s = make_plane_scene(
            V=self.nviews, H=self.H, W=self.W,
            seed=self.seed * 1000 + idx,
            gx=0.05 + 0.02 * (idx % 5), gy=-0.04 - 0.015 * (idx % 3),
        )
        for k in ("view_depths", "intrinsics", "extrinsics"):
            s.pop(k)
        return s


def batch_samples(samples) -> Dict:
    """Stack sample dicts (nested dicts of arrays) along a new leading
    batch axis."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: batch_samples([s[k] for s in samples]) for k in first}
    return np.stack(samples)


def batch_to_torch(batch: Dict, device) -> Dict:
    """A stacked batch as tensors on ``device``: the model inputs ``imgs``,
    ``proj_matrices`` and ``depth_values``, the train targets ``depth``
    and ``mask`` per stage, and a padded batch's ``valid`` mask. To a card
    the arrays go through pinned memory without blocking the host
    (``utils/graphs.to_device``)."""
    from ..utils.graphs import to_device

    def t(a):
        return to_device(a, device)

    return {
        "imgs": t(batch["imgs"]),
        "proj_matrices": {k: t(v) for k, v in batch["proj_matrices"].items()},
        "depth_values": t(batch["depth_values"]),
        "depth": {k: t(v) for k, v in batch["depth"].items()},
        "mask": {k: t(v) for k, v in batch["mask"].items()},
        **({"valid": t(batch["valid"])} if "valid" in batch else {}),
    }
