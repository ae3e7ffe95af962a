"""Metric sinks (reference utils.py:70-100 and its TensorBoard writer).

Counterpart of the JAX package's ``train/logging.py``: ``MetricWriter``
appends every scalar record to ``metrics.jsonl`` in the logdir, always, and
also writes scalars and images to TensorBoard when ``tensorboardX`` or
``torch.utils.tensorboard`` imports; nothing needs either.
``format_progress`` is the reference's console line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


def _summary_writer(logdir: str):
    """A TensorBoard ``SummaryWriter`` on ``logdir``, or None when neither
    ``tensorboardX`` nor ``torch.utils.tensorboard`` imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(logdir)


class MetricWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.jsonl_path = os.path.join(logdir, "metrics.jsonl")
        self._tb = _summary_writer(logdir)

    def scalars(self, mode: str, scalar_dict: Dict[str, float], step: int) -> None:
        rec = {
            "mode": mode,
            "step": int(step),
            "time": time.time(),
            **{k: float(v) for k, v in scalar_dict.items()},
        }
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalar_dict.items():
                self._tb.add_scalar(f"{mode}/{k}", float(v), int(step))

    def images(self, mode: str, images: Dict[str, np.ndarray], step: int) -> None:
        """[H, W] or [H, W, C] float arrays, each normalized to [0, 1]
        (reference save_images, utils.py:82-100); TensorBoard only."""
        if self._tb is None:
            return
        for k, img in images.items():
            arr = np.asarray(img, dtype=np.float32)
            if arr.ndim == 2:
                arr = arr[..., None]
            lo, hi = arr.min(), arr.max()
            arr = (arr - lo) / (hi - lo + 1e-12)
            self._tb.add_image(f"{mode}/{k}", arr, int(step), dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def format_progress(
    epoch: int, epochs: int, it: int, n_iters: int, lr: float,
    scalars: Dict[str, float], dt: float, tag: str = "Train",
) -> str:
    """The reference's console progress line (train_mvs4.py:164-186)."""
    g = lambda k: scalars.get(k, float("nan"))  # noqa: E731
    return (
        f"Epoch:{epoch + 1}/{epochs}, {tag} iter:{it}/{n_iters}, lr={lr:.2E}, "
        f"loss={g('loss'):.3f}, abs.depth.err.={g('abs_depth_error'):.2f}, "
        f"Thres1/2/4/8mm=({g('thres1mm_error') * 100:.1f}%,{g('thres2mm_error') * 100:.1f}%,"
        f"{g('thres4mm_error') * 100:.1f}%,{g('thres8mm_error') * 100:.1f}%), "
        f"mono_loss=({g('s0_d_loss'):.1f},{g('s1_d_loss'):.1f},{g('s2_d_loss'):.1f},{g('s3_d_loss'):.1f}), "
        f"stg_loss=({g('s0_c_loss'):.1f},{g('s1_c_loss'):.1f},{g('s2_c_loss'):.1f},{g('s3_c_loss'):.1f}), "
        f"range_err=({g('s0_range_err_ratio'):.2f},{g('s1_range_err_ratio'):.2f},"
        f"{g('s2_range_err_ratio'):.2f},{g('s3_range_err_ratio'):.2f}), "
        f"time = {dt:.3f}"
    )
