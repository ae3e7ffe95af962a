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
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..config import LossConfig
from ..models.losses import mvs4net_loss
from .metrics import depth_metrics
from .schedule import Schedule


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
    learning rate from its schedule."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


class TrainStep:
    """``step(batch) -> scalars``: one optimizer step on ``batch`` (a dict
    of tensors on the model's device: ``imgs``, ``proj_matrices``,
    ``depth_values``, ``depth`` and ``mask`` per stage). The scalars are
    0-d tensors on the device (reading one waits for the step). After the
    call each parameter's ``.grad`` holds this step's gradient; ``step``
    counts the steps taken and indexes the schedule. With ``with_images``
    the call returns ``(scalars, image_summaries(...))``."""

    def __init__(self, model, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, *, num_stages: int = 4, with_images: bool = False):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.schedule = schedule
        self.num_stages = num_stages
        self.last = f"stage{num_stages}"
        self.with_images = with_images
        self.step = 0

    def __call__(self, batch):
        self.model.train()
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        outputs = self.model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss, aux = mvs4net_loss(outputs, batch["depth"], batch["mask"], self.loss_cfg)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            mask = batch["mask"][self.last] > 0.5
            metrics = depth_metrics(outputs[self.last]["depth"], batch["depth"][self.last], mask)
        scalars = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}, **metrics}
        if self.with_images:
            return scalars, image_summaries(outputs, batch, self.num_stages)
        return scalars


def make_train_step(model, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                    schedule: Schedule, *, num_stages: int = 4,
                    with_images: bool = False) -> TrainStep:
    return TrainStep(model, loss_cfg, optimizer, schedule, num_stages=num_stages,
                     with_images=with_images)


def make_eval_step(model, loss_cfg: LossConfig, *, num_stages: int = 4,
                   with_images: bool = False):
    """Validation step (reference test_sample_depth): the eval forward, no
    gradients, the mono loss off. ``batch["valid"]`` ([B], optional) leaves
    padded samples out of every reduction. With ``with_images`` the call
    returns ``(scalars, image_summaries(...))``."""
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
        loss, aux = mvs4net_loss(outputs, batch["depth"], masks, eval_loss_cfg)
        mask = masks[last] > 0.5
        scalars = {"loss": loss, **aux,
                   **depth_metrics(outputs[last]["depth"], batch["depth"][last], mask, valid)}
        if with_images:
            return scalars, image_summaries(outputs, batch, num_stages)
        return scalars

    return step_fn
