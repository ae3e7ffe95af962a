"""The benchmark's side of the measured program: its configuration built
from the benchmark's file, the network with the benchmark's seeded
weights, and the scene pool of a traffic mix. The program's modules are
imported inside the functions, so that importing the benchmark loads
nothing of it."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from . import harness
from .traffic import plane_scenes

PROGRAM = harness.PROGRAM


def model_config(config: Dict):
    """The program's ``ModelConfig`` from the configuration file's keys."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config.items() if k in names})


def build_model(config: Dict, seed: int, device) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """``(model, weights)``: the program's network in eval mode on
    ``device`` holding the benchmark's seeded weights, and those weights as
    the benchmark made them (the reference's copy)."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    model = MVS4Net(model_config(config), device=device)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    weights = harness.make_weights(shapes, seed, device)
    model.load_state_dict(weights)
    return model, weights


# scenes rendered a call: the float64 render of a whole pool at once would
# set the run's memory peak instead of the program
RENDER_CHUNK = 4


def scenes(ctx, n: int, views: int, with_targets: bool = False) -> Dict:
    """``n`` scenes of the cell's traffic mix, drawn from the seed and
    rendered on the cell's device, ``RENDER_CHUNK`` at a time."""
    mix = ctx.traffic
    params = plane_scenes.scene_params(harness.seed_rng(ctx.seed, 2), n, views, mix)
    parts = [plane_scenes.render({k: v[i:i + RENDER_CHUNK] for k, v in params.items()}, views,
                                 mix["height"], mix["width"], mix["depth_range"], ctx.device,
                                 with_targets=with_targets)
             for i in range(0, n, RENDER_CHUNK)]
    return _cat(parts)


def _cat(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts]) for k in first}
    return torch.cat(parts)


def take(batch: Dict, sl) -> Dict:
    """The samples ``sl`` of a batch of tensors (nested dicts), contiguous."""
    return {k: take(v, sl) if isinstance(v, dict) else v[sl].contiguous()
            for k, v in batch.items()}
