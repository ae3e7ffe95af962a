"""The port's ``train/loop.fit`` against the JAX package's ``fit`` on the CPU.

Both train the same carried weights and BatchNorm statistics for one epoch
on the two-sample 64x64 two-view plane dataset of
tests/test_checkpoint_loop.py (B1, summary every step, the same shuffled
order), then validate with the eval forward, which in the port runs K6's
plain version on its route. Their ``metrics.jsonl`` records are compared.
This file holds only this test, so that its JAX compile has a worker of
its own.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    LossConfig as JaxLossConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    TrainConfig as JaxTrainConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data.loader import (
    DataLoader as JaxDataLoader,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train import fit as jax_fit
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train.schedule import (
    make_schedule as jax_make_schedule,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.loader import DataLoader
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.loop import fit
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)

from test_checkpoint_loop import PlaneDataset


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_matches_jax_fit(tmp_path):
    """One epoch of each framework's ``fit`` from the same weights (the
    JAX package's exact-gather warp, float32): the port's record of each
    step carries the JAX schedule's learning rate (float32 there: rtol
    1e-6); the step-0 loss agrees within 1e-5 relative (the same weights
    and batch, sums in another order); the step-1 loss and every
    ``fulltest`` average within 1e-3 of max(1, |JAX|) (one Adam step apart,
    whose float32 updates and argmax near-ties move the second step's
    hypotheses slightly)."""
    jcfg = JaxModelConfig(group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
                          warp_impl="gather", fused_topdown=False, pack_conv=False,
                          remat=False)
    jtcfg = JaxTrainConfig(epochs=1, lr=1e-3, weight_decay=1e-4, summary_freq=1,
                           warmup_iters=2)
    jlcfg = JaxLossConfig(inverse_depth=True)
    ds = PlaneDataset(n=2)

    sample = ds[0]
    shapes = jax.eval_shape(lambda: JaxMVS4Net(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(sample["imgs"][None]),
        {k: jnp.asarray(v[None]) for k, v in sample["proj_matrices"].items()},
        jnp.asarray(sample["depth_values"][None]), train=True))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    vs = jax.tree_util.tree_map_with_path(fill, shapes)

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_fit(JaxMVS4Net(jcfg), jax.tree_util.tree_map(jnp.asarray, vs),
            JaxDataLoader(ds, 1, shuffle=True, drop_last=True, num_workers=0),
            JaxDataLoader(ds, 1, num_workers=0), jtcfg, jlcfg, logdir=jdir,
            to_device=lambda b: jax.tree_util.tree_map(jnp.asarray, b))

    model = MVS4Net(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(vs))
    state = fit(model, DataLoader(ds, 1, shuffle=True, drop_last=True, num_workers=0),
                DataLoader(ds, 1, num_workers=0), TrainConfig(**dataclasses.asdict(jtcfg)),
                LossConfig(**dataclasses.asdict(jlcfg)), logdir=pdir,
                device=torch.device("cpu"))
    assert state.step == 2 and os.path.exists(os.path.join(pdir, "model_00.ckpt"))

    want, got = _records(jdir), _records(pdir)
    assert [(r["mode"], r["step"]) for r in got] == [(r["mode"], r["step"]) for r in want] == [
        ("train", 0), ("train", 1), ("test", 0), ("test", 1), ("fulltest", 2)]
    sched = jax_make_schedule("MS", 1e-3, milestones_iters=[12, 16, 18], gamma=0.5,
                              warmup_iters=2)
    for r in got[:2]:
        np.testing.assert_allclose(r["lr"], float(sched(r["step"])), rtol=1e-6)
    assert got[0]["lr"] != got[1]["lr"]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
    assert abs(got[1]["loss"] - want[1]["loss"]) <= 1e-3 * max(1.0, abs(want[1]["loss"]))
    full_got, full_want = got[-1], want[-1]
    keys = set(full_want) - {"mode", "step", "time"}
    assert keys and keys <= set(full_got)
    for k in sorted(keys):
        assert abs(full_got[k] - full_want[k]) <= 1e-3 * max(1.0, abs(full_want[k])), (
            k, full_got[k], full_want[k])
