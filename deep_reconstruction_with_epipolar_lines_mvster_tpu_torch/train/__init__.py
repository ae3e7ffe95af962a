"""Training of the port: loss, metrics, schedules and the train step."""

from .metrics import abs_depth_error, depth_metrics, thres_metric
from .schedule import make_schedule, warmup_multistep
from .step import TrainStep, make_eval_step, make_optimizer, make_train_step

__all__ = [
    "TrainStep",
    "abs_depth_error",
    "depth_metrics",
    "make_eval_step",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "thres_metric",
    "warmup_multistep",
]
