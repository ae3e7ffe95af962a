"""Data-parallel training and the sharded eval forward of the port.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one
program over a ``(data, space)`` device mesh; the port runs one process a
card for training (``torchrun``) and one process over a device list for
eval:

- ``pad_batch_to_multiple``: the trailing val batch wrapped up to the data
  width, with its ``valid`` mask (JAX ``:85-105``);
- ``split_batch``: rank ``r`` of ``n`` takes the contiguous slice ``r`` of
  its host's batch, what JAX's ``shard_batch`` over ``P("data")`` gives
  each device (``:48-82``);
- ``data_parallel``: a ``TrainStep`` made one rank's share of a
  data-parallel step (``DistributedDataParallel``, gradients averaged over
  the ranks), in either of the JAX package's two forms (``:203-263``):

  ``gspmd``: one training over the global batch, as GSPMD partitions it:
  train-mode BatchNorm normalises over every rank's samples
  (``TorchBatchNorm.sync_group``) and every masked mean of the loss takes
  its denominator over the global batch, each rank's loss scaled so that
  the average of the ranks' gradients is the global loss's;

  ``shard_map``: each rank's own batch statistics and masked means (the
  reference's DDP), the BatchNorm running statistics averaged over the
  ranks after each step (JAX ``train/step.py:118-127``);

  either way DDP keeps its buffers apart (``broadcast_buffers=False``) and
  the step's scalars are averaged over the ranks;
- ``sharded_eval_forward``: the eval forward over a device list laid out
  ``(data, space)``, one model replica a device, the ranks driven in
  lockstep from one thread: batch shards over ``data``, and over ``space``
  the model's row windows (``models/mvs4net.py``) whose rows each rank
  gathers from the others by peer copies into its own device (JAX ``shard_eval_forward_space`` and
  ``shard_eval_forward_shard_map``, ``:117-200``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import mean_tensors_across_ranks, world_size

DP_IMPLS = ("gspmd", "shard_map")


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def pad_batch_to_multiple(batch: Dict[str, Any], mult: int) -> Dict[str, Any]:
    """Pad every leaf's batch axis up to a multiple of ``mult`` by wrapping
    (sample ``i`` pads as sample ``i % n``), with a float32 ``valid`` mask
    (1 real, 0 padded); the batch itself when ``mult`` divides it. The eval
    step leaves padded samples out of every reduction, so the padded
    batch's scalars equal the unpadded batch's."""
    n = len(_first_leaf(batch))
    pad = (-n) % mult
    if pad == 0:
        return batch
    idx = np.arange(n + pad) % n
    out = _map_leaves(lambda x: np.asarray(x)[idx], batch)
    out["valid"] = (np.arange(n + pad) < n).astype(np.float32)
    return out


def split_batch(batch: Dict[str, Any], rank: int, ranks: int) -> Dict[str, Any]:
    """Rank ``rank``'s contiguous slice of ``batch`` (every leaf's batch
    axis cut in ``ranks`` equal parts); raises where ``ranks`` does not
    divide the batch, as GSPMD refuses it."""
    n = len(_first_leaf(batch))
    if n % ranks:
        raise ValueError(f"batch of {n} does not split over {ranks} ranks")
    k = n // ranks
    return _map_leaves(lambda x: x[rank * k:(rank + 1) * k], batch)


@dataclasses.dataclass
class DataParallel:
    """What a ``TrainStep`` needs to be one rank's share of a data-parallel
    step: the DDP-wrapped model it calls, the process group of the step's
    own reductions apart from DDP's (``group``: None in a world of one
    rank), and that group where the loss's masked means take the global
    batch (``loss_group``: ``gspmd`` only)."""

    runner: torch.nn.Module
    impl: str
    group: Optional[Any] = None
    loss_group: Optional[Any] = None

    def after_update(self, model: torch.nn.Module) -> None:
        """After the optimizer's step: under ``shard_map`` every BatchNorm's
        running statistics become their mean over the ranks."""
        if self.impl == "shard_map":
            from ..models.layers import TorchBatchNorm

            mean_tensors_across_ranks(
                [t for m in model.modules() if isinstance(m, TorchBatchNorm)
                 for t in (m.running_mean, m.running_var)], self.group)


def data_parallel(step, dp_impl: str = "gspmd", *, device=None):
    """Make ``step`` (a ``train.step.TrainStep``) this rank's share of a
    data-parallel step over the default process group, in the form
    ``dp_impl`` (``gspmd`` or ``shard_map``, module docstring). The model
    is wrapped in ``DistributedDataParallel`` (``device_ids`` on the card,
    ``broadcast_buffers=False``, ``find_unused_parameters=False``); the
    global reductions use a process group of their own, apart from DDP's
    gradient buckets. Returns ``step``."""
    from torch.nn.parallel import DistributedDataParallel

    from ..models.layers import TorchBatchNorm

    if dp_impl not in DP_IMPLS:
        raise ValueError(f"dp_impl {dp_impl!r}: one of {DP_IMPLS}")
    model = step.model
    device = torch.device(device) if device is not None else next(model.parameters()).device
    runner = DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)
    group = dist.new_group() if world_size() > 1 else None
    global_batch = dp_impl == "gspmd" and group is not None
    for m in model.modules():
        if isinstance(m, TorchBatchNorm):
            m.sync_group = group if global_batch else None
    step.dp = DataParallel(runner, dp_impl, group=group,
                           loss_group=group if global_batch else None)
    return step


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current card>``, so that equal devices compare
    equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _replicas(model, devices: Sequence[torch.device]) -> Dict[torch.device, torch.nn.Module]:
    """One eval-mode replica of ``model`` per distinct device: ``model``
    itself on its own device, a copy of its weights on each other one."""
    home = next(model.parameters()).device
    out = {}
    for dev in devices:
        if dev not in out:
            out[dev] = model if dev == home else copy.deepcopy(model).to(dev)
            out[dev].eval()
    return out


def _cat_outputs(parts: List[Dict[str, Dict[str, torch.Tensor]]], device) -> Dict:
    """The data shards' stage outputs joined along the batch on ``device``."""
    if len(parts) == 1:
        return {s: {k: v.to(device) for k, v in o.items()} for s, o in parts[0].items()}
    return {s: {k: torch.cat([p[s][k].to(device) for p in parts]) for k in o}
            for s, o in parts[0].items()}


def sharded_eval_forward(model, devices: Sequence, *, space: int = 1, space_halo: int = 48):
    """``forward(imgs, projs, dv) -> outputs``: the eval forward of
    ``model`` over ``devices`` laid out ``(data, space)``, ``data =
    len(devices) // space`` (device ``d * space + p`` runs data shard ``d``'s
    row window ``p``), under ``inference_mode``. The batch splits over
    ``data`` in contiguous equal parts (raises where it does not divide).
    One host thread drives every rank's ``MVS4Net.forward_steps`` in
    lockstep: it launches each rank's stage on that rank's device (the
    devices run them concurrently), then gives each rank the windowed
    stage's rows of its space group, copied into its device and joined.
    The outputs of every stage come back at full height on ``devices[0]``,
    joined along the batch. A device may repeat (``[cuda:0] * 4`` runs four
    windows on one card, the decomposition without the parallelism)."""
    devices = [_indexed(torch.device(d)) for d in devices]
    if space < 1 or len(devices) % space:
        raise ValueError(f"{len(devices)} devices do not lay out as (data, space={space})")
    data = len(devices) // space
    replicas = _replicas(model, devices)

    def card(dev):
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    @torch.inference_mode()
    def forward(imgs, projs, dv):
        B = imgs.shape[0]
        if B % data:
            raise ValueError(f"batch of {B} does not split over {data} data shards")
        b = B // data
        steps = []
        for i, dev in enumerate(devices):
            rows = slice(i // space * b, (i // space + 1) * b)
            with card(dev):
                steps.append(replicas[dev].forward_steps(
                    imgs[rows].to(dev), {k: v[rows].to(dev) for k, v in projs.items()},
                    dv[rows].to(dev), space_rank=i % space, space_shards=space,
                    space_halo=space_halo))
        own, results = [None] * len(steps), {}

        def advance(i, sent):
            with card(devices[i]):
                try:
                    own[i] = steps[i].send(sent)
                except StopIteration as done:
                    results[i] = done.value

        for i in range(len(steps)):
            advance(i, None)
        while not results:
            joined = []
            for i, dev in enumerate(devices):
                group = own[i // space * space:(i // space + 1) * space]
                with card(dev):
                    joined.append({k: torch.cat([r[k][0].to(dev) for r in group], dim=axis)
                                   for k, (_, axis) in group[0].items()})
            for i, sent in enumerate(joined):
                advance(i, sent)
        if len(results) != len(steps):
            raise RuntimeError("the ranks' forwards took different numbers of steps")
        return _cat_outputs([results[d * space] for d in range(data)], devices[0])

    return forward
