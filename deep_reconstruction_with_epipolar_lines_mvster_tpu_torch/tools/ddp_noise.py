#!/usr/bin/env python3
"""The train step's run-to-run noise on one card, bare and through
``data_parallel``, the readings behind ``checks.check_ddp_step``'s limits.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.ddp_noise

In a world of one rank over NCCL (a ``file://`` store), for the DTU recipe
(B6 V5 512x640 bf16, 3 steps, ``chip_smoke.py``'s scene and model) and the
small float32 step of ``checks.small_step_model`` (2 steps), runs from the
same seed in the order B B B B gspmd B shard_map B gspmd B gspmd gspmd
(B: the bare ``TrainStep``), then the same with
``torch.backends.cudnn.deterministic``. Each run's gaps (``checks._ddp_gaps``)
from the first four bare runs, the median over them: the whole first
gradient, a few tensors' first gradients (the FPN's 1x1 weights), the
parameters after the last step (relative L2, and max |diff|); and the
largest of each over the pairs of the first four bare runs. Prints the
card's name and power limit and one JSON line a sequence. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import checks
from ..config import setup_device
from ..models import MVS4Net
from ..ops import _build

ORDER = ("B", "B", "B", "B", "gspmd", "B", "shard_map", "B", "gspmd", "B", "gspmd", "gspmd")
WATCH = ("feature.out1.weight", "feature.inner1.weight", "feature.out3.weight",
         "feature.conv0.1.bn.bias")


def _maxabs_params(a, b) -> float:
    return max(float((a["last"][k] - b["last"][k]).abs().max()) for k in b["grads"])


def _readings(a, b):
    g = checks._ddp_gaps(a, b)
    return {"grads": g["grads"], **{n: g["grad_tensors"][n] for n in WATCH},
            "params_last": g["params_last"], "params_last_maxabs": _maxabs_params(a, b)}


def sequence(tag, device, make_model, batch, steps):
    runs = [checks._ddp_run(make_model, batch, steps, None if k == "B" else k, device)
            for k in ORDER]
    base = runs[:4]
    pairs = [_readings(a, b) for i, b in enumerate(base) for a in base[i + 1:]]
    out = {"tag": tag, "steps": steps,
           "bare_noise": {k: max(p[k] for p in pairs) for k in pairs[0]},
           "runs": []}
    for kind, run in zip(ORDER, runs):
        gaps = [_readings(run, b) for b in base]
        out["runs"].append({"kind": kind, "losses": run["losses"],
                            **{k: float(np.median([g[k] for g in gaps])) for k in gaps[0]}})
    print(json.dumps(out), flush=True)


def _chip_smoke():
    """``chip_smoke.py`` of the checkout this script lies in, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    if not torch.cuda.is_available():
        print("ddp_noise: needs a CUDA card", file=sys.stderr)
        return 1
    cs = _chip_smoke()

    device = setup_device()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    _build.build(_build.KERNELS)
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        dtu = cs._scene(cs.TRAIN_B, cs.TRAIN_V, cs.H, cs.W, device)
        small_cfg = checks.small_step_model().cfg
        small = checks.small_step_batch(device)
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            suffix = "_cudnn_deterministic" if deterministic else ""
            sequence("dtu_bf16" + suffix, device,
                     lambda: MVS4Net(cs.dtu_model_config(), device=device,
                                     generator=torch.Generator().manual_seed(cs.SEED + 5)),
                     dtu, 3)
            sequence("small_float32" + suffix, device,
                     lambda: MVS4Net(small_cfg, device=device,
                                     generator=torch.Generator().manual_seed(3)),
                     small, 2)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
