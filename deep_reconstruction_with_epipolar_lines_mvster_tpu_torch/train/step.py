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
    counts the steps taken and indexes the schedule."""

    def __init__(self, model, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, *, num_stages: int = 4):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.schedule = schedule
        self.last = f"stage{num_stages}"
        self.step = 0

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
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
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}, **metrics}


def make_train_step(model, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                    schedule: Schedule, *, num_stages: int = 4) -> TrainStep:
    return TrainStep(model, loss_cfg, optimizer, schedule, num_stages=num_stages)


def make_eval_step(model, loss_cfg: LossConfig, *, num_stages: int = 4):
    """Validation step (reference test_sample_depth): the eval forward, no
    gradients, the mono loss off. ``batch["valid"]`` ([B], optional) leaves
    padded samples out of every reduction."""
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
        return {"loss": loss, **aux,
                **depth_metrics(outputs[last]["depth"], batch["depth"][last], mask, valid)}

    return step_fn
