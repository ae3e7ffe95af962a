"""Training of the port: loss, metrics, schedules, the train step, the
epoch loop with checkpoints and logging, and the profiler."""

from .checkpoint import (
    checkpoint_path,
    find_latest_checkpoint,
    load_weights,
    restore_checkpoint,
    save_checkpoint,
)
from .loop import fit
from .metrics import DictAverageMeter, abs_depth_error, depth_metrics, thres_metric
from .schedule import make_schedule, warmup_multistep
from .step import TrainStep, image_summaries, make_eval_step, make_optimizer, make_train_step

__all__ = [
    "DictAverageMeter",
    "TrainStep",
    "abs_depth_error",
    "checkpoint_path",
    "depth_metrics",
    "find_latest_checkpoint",
    "fit",
    "image_summaries",
    "load_weights",
    "make_eval_step",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
    "thres_metric",
    "warmup_multistep",
]
