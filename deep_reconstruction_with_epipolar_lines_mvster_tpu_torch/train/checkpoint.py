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
import warnings
from typing import Optional

import torch

_CKPT_RE = re.compile(r"model_(\d+)\.ckpt$")


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(logdir, f"model_{epoch:02d}.ckpt")


def save_checkpoint(logdir: str, epoch: int, state) -> str:
    """Write ``state`` (a ``train.step.TrainStep``: its model, optimizer and
    step counter) as the checkpoint of ``epoch``; returns the path."""
    os.makedirs(logdir, exist_ok=True)
    optimizer = state.optimizer.state_dict()
    for group in optimizer["param_groups"]:
        # the train step's learning rate is a tensor on the device; the
        # file keeps the reference's Python float
        group["lr"] = float(group["lr"])
    payload = {
        "epoch": int(epoch),
        "model": state.model.state_dict(),
        "optimizer": optimizer,
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
    counter. Returns the epoch to continue at, the saved one + 1.

    The optimizer's ``load_state_dict`` replaces its state tensors, which a
    captured train step would still read: the step's graphs are dropped,
    and its next call captures anew (``fit`` restores before its first
    step, so that nothing is captured twice)."""
    blob = torch.load(path, map_location="cpu")
    state.model.load_state_dict(blob["model"])
    # Adam's ``capturable`` follows the device it runs on, not the one that
    # wrote the file; a capturable Adam keeps its step counts on that device
    capturable = [g["capturable"] for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(blob["optimizer"])
    for group, flag in zip(state.optimizer.param_groups, capturable):
        group["capturable"] = flag
        for p in group["params"] if flag else ():
            st = state.optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)
    state.step = int(blob["step"])
    state.reset_graphs()
    return int(blob["epoch"]) + 1


def load_weights(model, path: str) -> None:
    """Warm start (reference ``--loadckpt``): load the ``model`` state_dict
    of a ``.ckpt`` (the port's, or the reference's; reference
    test_mvs4.py:317) into ``model``, nothing else. Every parameter and
    buffer of the model must be in it, but for the learned positional
    encoding (``--pos_enc 2``, ``pos_enc.*``): the reference's ``--pos_enc``
    is a dead flag (MVS4Net.py:51-52), so its checkpoints never hold one,
    and the model keeps its fresh embeddings with a warning, as the JAX
    package's transplant does. Keys of parts this configuration does not
    build (e.g. the mono decoder of a ``--mono`` training run) are reported
    and skipped."""
    blob = torch.load(path, map_location="cpu")
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    missing, unexpected = model.load_state_dict(sd, strict=False)
    fresh = [k for k in missing if k.startswith("pos_enc.")]
    missing = [k for k in missing if not k.startswith("pos_enc.")]
    if missing:
        raise KeyError(f"{path}: checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    if fresh:
        warnings.warn(f"{path}: no learned positional encoding in the checkpoint (the "
                      f"reference's --pos_enc is a dead flag); {fresh} keep their fresh "
                      "initialization", stacklevel=2)
    if unexpected:
        print(f"{path}: {len(unexpected)} keys not used by this model, e.g. {unexpected[:3]}")
