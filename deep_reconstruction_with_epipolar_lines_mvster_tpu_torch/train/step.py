"""Train and eval steps.

Counterpart of the JAX package's ``train/step.py`` (reference
``train_sample`` / ``test_sample_depth``, ``train_mvs4.py:299-462``): train
forward -> ``mvs4net_loss`` -> backward -> Adam with L2 weight decay, and
the scalar set of the JAX steps. PyTorch keeps the state in the model and
the optimizer, so a step is a callable that updates them in place.

The optimizer is ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8,
weight_decay=wd)``: its ``weight_decay`` adds ``wd * param`` to the
gradient before the moments, the same L2-in-gradient as the JAX package's
``optax.add_decayed_weights`` followed by ``adam``.

On the card both steps are captured (``utils/graphs.capture``), as the JAX
package jits them (JAX ``train/loop.py:98-104``): one CUDA graph per batch
signature holds the train step's forward, loss, backward and Adam update,
another the eval step's forward and scalars; every later call replays its
graph. So do their data-parallel forms (``dp``, the eval step's
``group``), as the JAX package jits them under its mesh: the graph then
also holds DDP's gradient all-reduces and the step's own collectives.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch

from ..config import LossConfig
from ..models.losses import mvs4net_loss
from ..parallel.distributed import mean_scalars
from ..utils import graphs
from .metrics import depth_metrics
from .schedule import Schedule

# eager data-parallel steps before a capture: DDP's reducer rebuilds its
# gradient buckets after its first iteration and times its first ten with
# CUDA events read on the host, neither of which a capture may hold
# (PyTorch's notes on DDP under CUDA graphs ask for 11; tools/ddp_capture.py
# shows a capture after 10 failing)
DDP_WARMUP_STEPS = 11


def image_summaries(outputs, batch, num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """The reference's TensorBoard image set (train_mvs4.py:319-331,368-379)
    for batch element 0 (``save_images`` logs ``img[:1]``), as JAX
    ``image_summaries``: masked and unmasked depth, GT, the reference image,
    the mask, the absolute error map and the 1/2/4/8 mm error masks. float16
    on the device: the host fetches them only at summary steps."""
    last = f"stage{num_stages}"
    with torch.no_grad():
        depth_est = outputs[last]["depth"][0].float()
        mask = batch["mask"][last][0]
        err = (depth_est - batch["depth"][last][0]).abs() * mask
        images = {
            "depth_est": depth_est * mask,
            "depth_est_nomask": depth_est,
            "depth_gt": batch["depth"]["stage2"][0],
            "ref_img": batch["imgs"][0, 0],
            "mask": batch["mask"]["stage1"][0],
            "errormap": err,
        }
        for t in (1, 2, 4, 8):
            images[f"errormap_{t}mm_mask"] = ((err < float(t)) & (mask > 0.5)).float()
        return {k: v.to(torch.float16) for k, v in images.items()}


def make_optimizer(model: torch.nn.Module, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over every parameter of ``model``; the train step sets the
    learning rate from its schedule. On the card it is ``capturable``: its
    step counts live on the device and its update reads nothing on the
    host, so that the train step can be captured."""
    params = list(model.parameters())
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay,
                            capturable=bool(params) and params[0].device.type == "cuda")


class TrainStep:
    """``step(batch) -> scalars``: one optimizer step on ``batch`` (a dict
    of tensors on the model's device: ``imgs``, ``proj_matrices``,
    ``depth_values``, ``depth`` and ``mask`` per stage). The scalars are
    0-d tensors on the device (reading one waits for the step). After the
    call each parameter's ``.grad`` holds this step's gradient; ``step``
    counts the steps taken and indexes the schedule. With ``with_images``
    the call returns ``(scalars, image_summaries(...))``.

    The learning rate is ``lr``, a 0-d float64 tensor on the model's
    device that the call fills from ``schedule(step)`` and sets as every
    parameter group's ``lr``, so that a captured step reads the rate of the
    step it replays (on the CPU Adam's update is then bit-equal to its
    update with a Python float). On the card the step is captured once per
    batch signature and replayed (module docstring); a checkpoint that
    replaces the optimizer's state (``optimizer.load_state_dict``) must be
    restored before the first call, or be followed by ``reset_graphs()``
    (``train/checkpoint.restore_checkpoint`` does both in order).

    ``dp`` (set by ``parallel.mesh.data_parallel``) makes the call this
    rank's share of a data-parallel step: the forward through the
    DDP-wrapped model, the loss's masked means over the global batch under
    ``gspmd``, the BatchNorm running statistics averaged over the ranks
    after the update under ``shard_map``, and the scalars averaged over the
    ranks, as the JAX step's under a mesh; captured the same way, its
    collectives inside the graph, after a warm-up of ``DDP_WARMUP_STEPS``
    eager steps."""

    def __init__(self, model, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, *, num_stages: int = 4, with_images: bool = False):
        self.model = model
        self.dp = None
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.schedule = schedule
        self.num_stages = num_stages
        self.last = f"stage{num_stages}"
        self.with_images = with_images
        self.step = 0
        self.lr = torch.zeros((), dtype=torch.float64,
                              device=next(model.parameters()).device)
        # the graph holds the step weakly: no reference cycle, so a step that
        # is dropped frees its graph's memory pool at once
        me = weakref.ref(self)
        self._captured = graphs.capture(lambda batch: me()._step(batch), "train step",
                                        warmup=lambda batch: me()._warm_up(batch))

    def __call__(self, batch):
        self.model.train()
        self.lr.fill_(self.schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        out = self._captured(batch)
        self.step += 1
        return out

    def reset_graphs(self) -> None:
        """Drop the captured graphs: the next call captures anew."""
        self._captured.reset()

    def _step(self, batch):
        """The device work of one step: forward, loss, backward, Adam, the
        scalars (and images)."""
        self.optimizer.zero_grad(set_to_none=True)
        dp = self.dp
        runner = self.model if dp is None else dp.runner
        outputs = runner(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss, aux = mvs4net_loss(outputs, batch["depth"], batch["mask"], self.loss_cfg,
                                 group=None if dp is None else dp.loss_group)
        loss.backward()
        self.optimizer.step()
        if dp is not None:
            dp.after_update(self.model)
        with torch.no_grad():
            mask = batch["mask"][self.last] > 0.5
            metrics = depth_metrics(outputs[self.last]["depth"], batch["depth"][self.last], mask)
        scalars = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}, **metrics}
        if dp is not None:
            scalars = mean_scalars(scalars)
        if self.with_images:
            return scalars, image_summaries(outputs, batch, self.num_stages)
        return scalars

    def _warm_up(self, batch) -> None:
        """The capture's warm-up (``utils/graphs``): one eager step, which
        makes what a step creates on first use (Adam's moments and step
        counts, the gradients, the kernel libraries, cached tables), or
        under ``dp`` ``DDP_WARMUP_STEPS`` of them (DDP's bucket rebuild
        and timed iterations, the process groups' communicators); then the
        model's parameters and buffers and the optimizer's state are put
        back as they were (a moment that the steps created is zeroed, as
        Adam creates it), so that the call still takes one step, the
        replay's."""
        state = [*self.model.parameters(), *self.model.buffers(),
                 *(v for st in self.optimizer.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor))]
        with torch.no_grad():
            kept = {id(t): (t, t.clone()) for t in state}
        for _ in range(1 if self.dp is None else DDP_WARMUP_STEPS):
            self._step(batch)
        with torch.no_grad():
            for t, saved in kept.values():
                t.copy_(saved)
            for st in self.optimizer.state.values():
                for v in st.values():
                    if isinstance(v, torch.Tensor) and id(v) not in kept:
                        v.zero_()


def make_train_step(model, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                    schedule: Schedule, *, num_stages: int = 4,
                    with_images: bool = False) -> TrainStep:
    return TrainStep(model, loss_cfg, optimizer, schedule, num_stages=num_stages,
                     with_images=with_images)


def make_eval_step(model, loss_cfg: LossConfig, *, num_stages: int = 4,
                   with_images: bool = False, group=None):
    """Validation step (reference test_sample_depth): the eval forward, no
    gradients, the mono loss off. ``batch["valid"]`` ([B], optional) leaves
    padded samples out of every reduction. With ``with_images`` the call
    returns ``(scalars, image_summaries(...))``. ``group`` (a process
    group): this rank's slice of a batch split over the group's ranks, the
    scalars those of the whole batch on every rank, as the JAX eval step's
    under a mesh. The step is captured on the card (module docstring), the
    group's all-reduces inside its graph."""
    eval_loss_cfg = dataclasses.replace(loss_cfg, mono=False)
    last = f"stage{num_stages}"

    @torch.no_grad()
    def step_fn(batch) -> Dict[str, torch.Tensor]:
        model.eval()
        outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        valid = batch.get("valid")
        masks = batch["mask"]
        if valid is not None:
            masks = {k: v * valid[:, None, None] for k, v in masks.items()}
        loss, aux = mvs4net_loss(outputs, batch["depth"], masks, eval_loss_cfg, group=group)
        mask = masks[last] > 0.5
        scalars = {"loss": loss, **aux,
                   **depth_metrics(outputs[last]["depth"], batch["depth"][last], mask, valid,
                                   group)}
        if group is not None:
            scalars = mean_scalars(scalars, group)
        if with_images:
            return scalars, image_summaries(outputs, batch, num_stages)
        return scalars

    return graphs.capture(step_fn, "eval step")
