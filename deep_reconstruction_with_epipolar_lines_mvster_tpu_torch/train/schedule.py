"""Learning-rate schedules, plain ``step -> lr`` functions.

Counterpart of the JAX package's ``train/schedule.py`` (reference scheduler
menu, ``train_mvs4.py:124-137``): ``MS`` (WarmupMultiStepLR, milestones in
iterations), ``cos``, ``onecycle``, ``CyclicLR_tri2`` and ``exponent``, with
the same formulas as the optax schedules that package builds on. The train
step sets the optimizer's learning rate from the schedule at each step.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def warmup_multistep(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float,
    *,
    warmup_factor: float = 1.0 / 3.0,
    warmup_iters: int = 500,
    warmup_method: str = "linear",
) -> Schedule:
    """WarmupMultiStepLR: linear (or constant) warmup times
    ``gamma ** bisect_right(milestones, step)`` (reference utils.py:241-254)."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        if step >= warmup_iters:
            warm = 1.0
        elif warmup_method == "linear":
            alpha = step / warmup_iters
            warm = warmup_factor * (1 - alpha) + alpha
        else:
            warm = warmup_factor
        return base_lr * warm * gamma ** bisect.bisect_right(ms, step)

    return schedule


def cosine(base_lr: float, total_steps: int) -> Schedule:
    """CosineAnnealingLR with eta_min=0 (optax ``cosine_decay_schedule``)."""

    def schedule(step: int) -> float:
        t = min(step, total_steps)
        return base_lr * 0.5 * (1 + math.cos(math.pi * t / total_steps))

    return schedule


def onecycle(base_lr: float, total_steps: int, pct_start: float = 0.3,
             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """OneCycleLR with max_lr=base_lr (optax ``cosine_onecycle_schedule``):
    cosine from ``base/div`` up to ``base`` over the first ``pct_start`` of
    the steps, then down to ``base/(div*final_div)``."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [base_lr / div_factor, base_lr, base_lr / (div_factor * final_div_factor)]

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if step >= bounds[-1] else 0.0

    return schedule


def exponent(base_lr: float, steps_per_epoch: int, gamma: float = 0.17) -> Schedule:
    """Per-epoch exponential decay, ``lr = base * 0.17 ** epoch`` (the
    reference's intended ExponentialLR, stepped once per epoch)."""
    spe = max(1, int(steps_per_epoch))
    return lambda step: base_lr * gamma ** (step // spe)


def cyclic_tri2(base_lr: float, max_lr: float, step_size_up: int = 4) -> Schedule:
    """CyclicLR ``mode="triangular2"`` stepped per iteration:
    ``cycle = floor(1 + step/(2*up))``, ``x = |step/up - 2*cycle + 1|``,
    ``lr = base + (max-base) * max(0, 1-x) / 2**(cycle-1)``."""
    up = float(step_size_up)

    def schedule(step: int) -> float:
        cycle = math.floor(1.0 + step / (2.0 * up))
        x = abs(step / up - 2.0 * cycle + 1.0)
        return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x) * 2.0 ** (1.0 - cycle)

    return schedule


def make_schedule(
    name: str,
    base_lr: float,
    *,
    milestones_iters: Sequence[int] = (),
    gamma: float = 0.5,
    total_steps: int = 0,
    warmup_iters: int = 500,
    steps_per_epoch: int = 1,
) -> Schedule:
    if name == "MS":
        return warmup_multistep(base_lr, milestones_iters, gamma, warmup_iters=warmup_iters)
    if name == "cos":
        return cosine(base_lr, total_steps)
    if name == "onecycle":
        return onecycle(base_lr, total_steps)
    if name == "CyclicLR_tri2":
        return cyclic_tri2(base_lr, base_lr * 100.0, step_size_up=4)
    if name == "exponent":
        return exponent(base_lr, steps_per_epoch)
    raise ValueError(f"unknown lr scheduler {name!r}")
