"""Convergence demo: the DTU-recipe model trained on synthetic planes.

Counterpart of the JAX repo's ``_train_demo.py``: the flagship model in
bf16 with mono (``graft_entry.dtu_model_config``), the recipe loss
(``checks.RECIPE_LOSS``: inverse depth, mono, l1_lw 0.003, 3 Sinkhorn
iterations), Adam at lr 1e-3 and weight decay 1e-4, 8 plane scenes
``make_plane_scene(V=3, H=128, W=128, seed=i, gx=0.1*(i%3),
gy=-0.05*(i%2))`` in two batches of 4, alternated for 300 steps through
``train.step.TrainStep``. It prints the loss, the absolute depth error and
the share of pixels off by more than 8 mm at steps 0, 10, 50, 100, 200 and
the last, then the total seconds.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.train_demo [--steps 300] [--device cpu]

It runs on the card; without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from ..checks import RECIPE_LOSS
from ..config import setup_device
from ..data.synthetic import batch_samples, batch_to_torch, make_plane_scene
from ..graft_entry import dtu_model_config
from ..models import MVS4Net
from ..train.schedule import warmup_multistep
from ..train.step import make_optimizer, make_train_step

B, V, H, W = 4, 3, 128, 128
SCENES = 8
REPORT = (0, 10, 50, 100, 200)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="train the flagship model on synthetic planes")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--device", default=None, help="cpu: the plain versions on the CPU")
    a = p.parse_args(argv)
    dev = setup_device(a.device)
    scenes = [make_plane_scene(V=V, H=H, W=W, seed=i, gx=0.1 * (i % 3), gy=-0.05 * (i % 2))
              for i in range(SCENES)]
    batches = [batch_to_torch(batch_samples(scenes[i:i + B]), dev) for i in range(0, SCENES, B)]
    model = MVS4Net(dtu_model_config(), device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, RECIPE_LOSS, make_optimizer(model, 1e-4),
                           warmup_multistep(1e-3, [100_000], 0.5))
    report = set(r for r in REPORT if r < a.steps) | {a.steps - 1}
    seen = {}
    t0 = time.perf_counter()
    for i in range(a.steps):
        sc = step(batches[i % len(batches)])
        if i in report:
            sc = {k: float(v) for k, v in sc.items()}
            if not all(math.isfinite(sc[k]) for k in ("loss", "abs_depth_error")):
                raise RuntimeError(f"step {i}: non-finite scalars {sc}")
            seen[i] = sc
            print(f"step {i}: loss={sc['loss']:.3f} abs_err={sc['abs_depth_error']:.2f} "
                  f"thres8mm={sc['thres8mm_error'] * 100:.1f}%", flush=True)
    total = time.perf_counter() - t0
    print("total", round(total, 1), "s", flush=True)
    return {"steps": seen, "seconds": total}


if __name__ == "__main__":
    main()
