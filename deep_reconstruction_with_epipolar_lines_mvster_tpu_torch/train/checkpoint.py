"""Checkpoint save, resume and warm start.

Counterpart of the JAX package's ``train/checkpoint.py`` (reference
semantics, train_mvs4.py:193-201,532-555):

- ``save_checkpoint`` writes ``{logdir}/model_{epoch:02d}.ckpt`` with the
  model, the optimizer and the step, through a ``.tmp`` file and
  ``os.replace``, so a reader never sees half a file;
- ``--resume``: ``find_latest_checkpoint`` picks the file with the largest
  epoch suffix, ``restore_checkpoint`` restores the model, the optimizer and
  the step counter and returns the epoch to continue at. The schedules are
  pure functions of the step (``train/schedule.py``), so restoring the step
  restores the learning-rate curve;
- ``--loadckpt``: ``load_weights`` loads the model's weights only.

The format is the reference's own ``.ckpt``: ``torch.save`` of ``{"epoch",
"model": state_dict, "optimizer": state_dict, "step"}``, with the
reference's ``state_dict`` keys, so the JAX package's ``load_weights``
reads a port checkpoint through its PyTorch path.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(logdir, f"model_{epoch:02d}.ckpt")


def save_checkpoint(logdir: str, epoch: int, state) -> str:
    """Write ``state`` (a ``train.step.TrainStep``: its model, optimizer and
    step counter) as the checkpoint of ``epoch``; returns the path."""
    os.makedirs(logdir, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    path = checkpoint_path(logdir, epoch)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def find_latest_checkpoint(logdir: str) -> Optional[str]:
    if not os.path.isdir(logdir):
        return None
    best, best_epoch = None, -1
    for fn in os.listdir(logdir):
        m = _CKPT_RE.search(fn)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(logdir, fn)
    return best


def restore_checkpoint(path: str, state) -> int:
    """Full resume into ``state`` (a ``TrainStep``): the model's parameters
    and buffers, the optimizer's moments and step counts, and the step
    counter. Returns the epoch to continue at, the saved one + 1."""
    blob = torch.load(path, map_location="cpu")
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return int(blob["epoch"]) + 1


def load_weights(model, path: str) -> None:
    """Warm start (reference ``--loadckpt``): load the ``model`` state_dict
    of a ``.ckpt`` (the port's, or the reference's; reference
    test_mvs4.py:317) into ``model``, nothing else. Every parameter and
    buffer of the model must be in it; keys of parts this configuration does
    not build (e.g. the mono decoder of a ``--mono`` training run) are
    reported and skipped."""
    blob = torch.load(path, map_location="cpu")
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path}: checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    if unexpected:
        print(f"{path}: {len(unexpected)} keys not used by this model, e.g. {unexpected[:3]}")
