"""Epoch-level training (reference train(), train_mvs4.py:118-247).

Counterpart of the JAX package's ``train/loop.py:fit``: the learning-rate
schedule with its milestones counted in iterations
(``len(train_loader) * epoch``, reference :120-126), resume from the latest
checkpoint (the schedule is a pure function of the restored step), the
train steps with the scalars and images logged every ``summary_freq``
steps, a checkpoint every ``save_freq`` epochs, and validation with a
``DictAverageMeter`` every ``eval_freq``-th epoch and after the last one.
On the card the train and eval steps are captured graphs
(``train/step.py``), fed by pinned copies of each batch
(``data/synthetic.batch_to_torch``).

Data-parallel over the ranks of the default process group (from
``parallel.init_distributed``), the loaders giving each rank its share of
its host's batches (``DataLoader(rank_in_host=, ranks_in_host=)``, a
trailing validation batch padded to the ranks): the train step becomes
this rank's share of one (``parallel.mesh.data_parallel``, ``dp_impl``
``gspmd`` or ``shard_map``); the validation scalars are those of the whole
batch; rank 0 alone prints, logs and writes checkpoints.

``metrics.jsonl`` gets the JAX package's records (``train``, ``test`` and
``fulltest``, with the same steps and scalars); besides, each ``train``
record carries the step's ``lr`` (which the JAX loop prints but does not
record) and each ``train`` and ``test`` record the host seconds of its step
(``step_s``: from the batch's copy to the device to its scalars on the
host).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..config import LossConfig, TrainConfig
from ..data.synthetic import batch_to_torch
from ..parallel import data_parallel, is_host0
from ..parallel.distributed import sync_hosts
from .checkpoint import find_latest_checkpoint, restore_checkpoint, save_checkpoint
from .logging import MetricWriter, format_progress
from .metrics import DictAverageMeter
from .schedule import make_schedule
from .step import TrainStep, make_eval_step, make_optimizer, make_train_step


def _images_to_host(images):
    return {k: v.float().cpu().numpy() for k, v in images.items()}


def fit(
    model,
    train_loader,
    val_loader,
    train_cfg: TrainConfig,
    loss_cfg: LossConfig,
    *,
    logdir: str,
    device: torch.device,
    resume: bool = False,
    dp_impl: str = "gspmd",
) -> TrainStep:
    """Train ``model`` (on ``device``) for ``train_cfg.epochs`` epochs of
    ``train_loader`` (numpy batches, copied to ``device`` per step; in a
    process group, this rank's share of its host's batch); returns the
    ``TrainStep``, which holds the model, the optimizer and the step
    count."""
    steps_per_epoch = len(train_loader)
    milestones = [steps_per_epoch * int(e) for e in train_cfg.lr_milestones]
    schedule = make_schedule(
        train_cfg.lr_scheduler,
        train_cfg.lr,
        milestones_iters=milestones,
        gamma=1.0 / train_cfg.lr_gamma_divisor,
        total_steps=train_cfg.epochs * steps_per_epoch,
        warmup_iters=train_cfg.warmup_iters,
        steps_per_epoch=steps_per_epoch,
    )
    optimizer = make_optimizer(model, train_cfg.weight_decay)
    train_step = make_train_step(model, loss_cfg, optimizer, schedule, with_images=True)
    host0 = is_host0()
    group = None
    if dist.is_initialized():
        data_parallel(train_step, dp_impl, device=device)
        group = train_step.dp.group

    # the restore comes before the first step: on the card that step
    # captures the graph, which then reads the restored optimizer state
    start_epoch = 0
    if resume:
        latest = find_latest_checkpoint(logdir)
        if latest is not None:
            start_epoch = restore_checkpoint(latest, train_step)
            if host0:
                print(f"resumed from {latest} at epoch {start_epoch}")

    eval_step = make_eval_step(model, loss_cfg, with_images=True, group=group)
    writer = MetricWriter(logdir) if host0 else None
    put = lambda b: batch_to_torch(b, device)  # noqa: E731

    for epoch in range(start_epoch, train_cfg.epochs):
        if host0:
            print(f"Epoch {epoch + 1}:")
        train_loader.set_epoch(epoch)
        for it, batch in enumerate(train_loader):
            t0 = time.perf_counter()
            global_step = steps_per_epoch * epoch + it
            scalars, images = train_step(put(batch))
            if host0 and global_step % train_cfg.summary_freq == 0:
                scalars = {k: float(v) for k, v in scalars.items()}
                dt = time.perf_counter() - t0
                lr = schedule(global_step)
                writer.scalars("train", {**scalars, "lr": lr, "step_s": dt}, global_step)
                writer.images("train", _images_to_host(images), global_step)
                print(format_progress(epoch, train_cfg.epochs, it, steps_per_epoch, lr,
                                      scalars, dt), flush=True)

        if host0 and (epoch + 1) % train_cfg.save_freq == 0:
            save_checkpoint(logdir, epoch, train_step)
        sync_hosts()

        if val_loader is not None and (
            epoch % train_cfg.eval_freq == 0 or epoch == train_cfg.epochs - 1
        ):
            meter = DictAverageMeter()
            for it, batch in enumerate(val_loader):
                t0 = time.perf_counter()
                scalars, images = eval_step(put(batch))
                scalars = {k: float(v) for k, v in scalars.items()}
                dt = time.perf_counter() - t0
                meter.update(scalars)
                if host0 and it % train_cfg.summary_freq == 0:
                    step = steps_per_epoch * epoch + it
                    writer.scalars("test", {**scalars, "step_s": dt}, step)
                    writer.images("test", _images_to_host(images), step)
            if host0:
                avg = meter.mean()
                writer.scalars("fulltest", avg, steps_per_epoch * (epoch + 1))
                print("avg_test_scalars:", avg, flush=True)

    if writer is not None:
        writer.close()
    return train_step

