"""The port's data-parallel training (``parallel/``) against the JAX
package's mesh steps on the CPU.

Two ``gloo`` processes (``tests/torch_port_dp_worker.py``, which import
torch and the port only) each take one sample of a B2 V3 64x128 batch and
run one ``data_parallel`` Adam step, for ``dp_impl`` ``gspmd`` and
``shard_map``; the JAX package runs ``shard_train_step`` and
``shard_train_step_shard_map`` on a (2, 1) mesh of the conftest's virtual
CPU devices from the same seeded weights. The JAX step's optimizer is a
gradient capture (its state after the update is the gradient tree), and
Adam is applied to those gradients with optax, which is the JAX step's
Adam update. Inputs come from numpy seeds; every tolerance is stated.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    LossConfig as JaxLossConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.parallel import (
    make_mesh,
    replicate,
    shard_batch,
    shard_train_step,
    shard_train_step_shard_map,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.parallel.mesh import (
    pad_batch_to_multiple as jax_pad_batch_to_multiple,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train import step as jax_step
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
    LossConfig,
    ModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.loader import DataLoader
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel import (
    HostMesh,
    pad_batch_to_multiple,
    reduce_scalars_across_hosts,
    split_batch,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_grads_to_port,
    jax_variables_to_state_dict,
)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_port_dp_worker.py"
B, V, H, W = 2, 3, 64, 128
# the recipe's loss (scripts/train_dtu.sh), 3 Sinkhorn iterations
RECIPE_LOSS = dict(stage_lw=(1.0, 1.0, 1.0, 1.0), l1_lw=0.003, ot_lw=1.0, ot_iter=3,
                   inverse_depth=True, mono=True)
# Adam's first step moves every entry by lr * g / (|g| + eps), about
# ±lr: a gradient entry near zero whose sign differs between the frameworks
# (the network's float32 gradients are ill-conditioned, see
# tests/test_torch_port_train.py) moves a parameter by up to 2 lr, so lr
# 1e-5 keeps that under the 1e-4 limit; the gradients themselves are held
# directly
LR, WD = 1e-5, 1e-4
WORKER_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads, as tests/test_torch_port_train_stack.py sets them:
    with a thread per core, the small model's thousands of operators wait
    at OpenMP barriers for threads that other test workers keep off the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfg():
    return JaxModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
        mono=True, attn_temp=2.0, dtype="float32", remat=False,
        warp_impl="gather", fused_topdown=False, pack_conv=False,
    )


def _grad_capture():
    """An optax transformation whose state after one update is that
    update's gradient tree, and whose update is zero."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(dp_impl: str, spec_path: Path, out_path: Path, world: int = 2):
    """Start the ``world`` gloo ranks; ``_finish_workers`` waits for them,
    so that the caller's own work runs meanwhile."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(port), dp_impl,
         str(spec_path), str(out_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)], out_path


def _finish_workers(started):
    """Wait for the ranks (each within ``WORKER_TIMEOUT_S``, killed past
    it) and return what rank 0 wrote."""
    procs, out_path = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return torch.load(out_path, weights_only=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded flax variables (the shapes of a train-mode init) and the
    batches: the train batch of B samples, a val batch of 3."""
    train = batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)])
    val = batch_samples([make_plane_scene(V=V, H=H, W=W, seed=10 + i) for i in range(3)])
    jcfg = _cfg()
    jnet = JaxMVS4Net(jcfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, train)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jbatch["imgs"], jbatch["proj_matrices"],
        jbatch["depth_values"], train=True))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    vs = jax.tree_util.tree_map_with_path(fill, shapes)
    spec_path = tmp_path_factory.mktemp("dp") / "spec.pt"
    torch.save({"cfg": dataclasses.asdict(jcfg), "state_dict": jax_variables_to_state_dict(vs),
                "loss": RECIPE_LOSS, "lr": LR, "wd": WD, "train": train, "val": val}, spec_path)
    return {"jcfg": jcfg, "jnet": jnet, "vs": vs, "train": train, "val": val,
            "spec": spec_path}


def _jax_mesh_step(setup, dp_impl):
    """The JAX package's mesh step on (2, 1) virtual CPU devices: scalars,
    the gradient tree, the updated BatchNorm statistics, and the parameters
    after the JAX package's Adam (``make_optimizer``) on that gradient."""
    jnet, vs = setup["jnet"], setup["vs"]
    lcfg = JaxLossConfig(**RECIPE_LOSS)
    tx = _grad_capture()
    mesh = make_mesh(jax.devices()[:2], space=1)
    if dp_impl == "gspmd":
        step = shard_train_step(jax_step.make_train_step(jnet, lcfg, tx), mesh)
    else:
        step = shard_train_step_shard_map(
            jax_step.make_train_step(jnet, lcfg, tx, axis_name="data"), mesh)
    state = replicate(jax_step.TrainState.create(jax.tree_util.tree_map(jnp.asarray, vs), tx),
                      mesh)
    with mesh:
        new_state, scalars = step(state, shard_batch(setup["train"], mesh))
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)
    adam = jax_step.make_optimizer(lambda _: LR, WD)
    params = jax.tree_util.tree_map(jnp.asarray, vs["params"])
    updates, _ = adam.update(grads, adam.init(params), params)
    new_params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "grads": jax_grads_to_port(grads),
            "state_dict": jax_variables_to_state_dict({"params": new_params,
                                                       "batch_stats": stats})}


def _port_one_process(setup, shares):
    """The one-process port step on each batch of ``shares``: the mean
    over the shares of the scalars, the gradients (captured before Adam)
    and the state after the step; the reference the ranks' data-parallel
    step must reproduce."""
    out = []
    for batch in shares:
        port = MVS4Net(ModelConfig(**dataclasses.asdict(setup["jcfg"])), device="cpu")
        port.load_state_dict(jax_variables_to_state_dict(setup["vs"]))
        opt = make_optimizer(port, WD)
        step = make_train_step(port, LossConfig(**RECIPE_LOSS), opt, lambda i: LR)
        grads = {}
        opt.register_step_pre_hook(lambda o, a, k, g=grads, m=port: g.update(
            {n: p.grad.clone() for n, p in m.named_parameters()}))
        scalars = step(batch_to_torch(batch, "cpu"))
        out.append((scalars, grads, port.state_dict()))

    def mean(i):
        return {k: sum(o[i][k] for o in out) / len(out) for k in out[0][i]}

    return {"scalars": {k: v.item() for k, v in mean(0).items()}, "grads": mean(1),
            "state_dict": mean(2)}


def _held(got, want, limit, what):
    """max|got - want| <= limit * max(1, max|want|) for every tensor."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = max(1.0, float(w.abs().max()))
        err = float((got[k].float() - w.float()).abs().max())
        assert err <= limit * scale, (what, k, err)


# each tensor's gradient against the JAX step's, relative to its max|grad|
# (worst tensor, median tensor): under gspmd the one-process step's limits
# (tests/test_torch_port_train.py); under shard_map each rank trains on one
# sample, its train-mode BatchNorm on that sample's statistics, and the
# second sample's one-sample step is worse conditioned in both frameworks:
# the JAX shard_map step equals the mean of JAX's one-device steps on the
# two shares bit for bit, and the port's one-process steps on the shares
# differ from JAX's by as much as its two ranks do (measured worst 4.5e-2,
# reg.2.conv3.conv.weight; median 4.3e-4)
GRAD_LIMIT = {"gspmd": (3e-2, 1e-4), "shard_map": (6e-2, 1e-3)}


@pytest.mark.parametrize("dp_impl", ["gspmd", "shard_map"])
def test_two_process_train_step_matches_jax_mesh_step(setup, dp_impl, tmp_path):
    """Two gloo ranks of the port's data-parallel step against the JAX
    package's mesh step of the same ``dp_impl`` (the two are different
    trainings: global-batch BatchNorm and masked means under gspmd, per-rank
    ones under shard_map):

    - the loss within 1e-5 relative, every other scalar within 1e-4 of
      max(1, |value|) (an argmax near-tie that flips moves a depth metric
      by one pixel's share);
    - every gradient (DDP's average) within ``GRAD_LIMIT[dp_impl]`` of its
      tensor's max|grad| (the worst tensor, the median tensor);
    - every parameter after one Adam step, and every BatchNorm running
      statistic, within 1e-4 of max(1, max|value|) of its tensor.

    Beside JAX, the same step in one process: under gspmd the one-process
    step on the whole batch, under shard_map the mean of the one-process
    steps on each rank's share; scalars, gradients (but the reg nets'
    ``prob.bias``, analytically zero) and the state after the step within
    1e-4 of max(1, max|value|) (measured <= 1.4e-5)."""
    started = _start_workers(dp_impl, setup["spec"], tmp_path / "out.pt")
    try:
        want = _jax_mesh_step(setup, dp_impl)
    finally:
        got = _finish_workers(started)
    js, ts = want["scalars"], got["scalars"]
    assert ts.keys() == js.keys()
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
    for k in js:
        assert abs(ts[k] - js[k]) <= 1e-4 * max(1.0, abs(js[k])), (k, ts[k], js[k])
    rel = []
    for k, g in want["grads"].items():
        if k.endswith("prob.bias"):       # analytically zero
            continue
        scale = float(g.abs().max())
        rel.append(float((got["grads"][k] - g).abs().max()) / scale)
        assert rel[-1] <= GRAD_LIMIT[dp_impl][0], (k, rel[-1])
    assert float(np.median(rel)) <= GRAD_LIMIT[dp_impl][1], np.median(rel)
    _held(got["state_dict"], want["state_dict"], 1e-4, "jax")
    assert sum(k.endswith(("running_mean", "running_var")) for k in want["state_dict"]) \
        == 2 * (11 + 4 * 10 + 3)          # stem, 4 x reg2d, mono decoder

    shares = ([setup["train"]] if dp_impl == "gspmd"
              else [split_batch(setup["train"], r, 2) for r in range(2)])
    one = _port_one_process(setup, shares)
    for k, v in one["scalars"].items():
        assert abs(ts[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, ts[k], v)
    _held(got["grads"], {k: v for k, v in one["grads"].items()
                         if not k.endswith("prob.bias")}, 1e-4, "one-process grads")
    _held(got["state_dict"], one["state_dict"], 1e-4, "one-process state")

    # the val batch of 3, padded to 4 and split over the ranks, gives the
    # one-process unpadded scalars (rtol 1e-6, atol 1e-7 as JAX
    # tests/test_parallel.py:232); the ranks' mean of {rank + 1} is 1.5
    port = MVS4Net(ModelConfig(**dataclasses.asdict(setup["jcfg"])), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(setup["vs"]))
    ref = make_eval_step(port, LossConfig(**RECIPE_LOSS))(batch_to_torch(setup["val"], "cpu"))
    for k, v in ref.items():
        np.testing.assert_allclose(got["val_scalars"][k], v.item(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert got["reduced"] == {"rank": 1.5}


def test_pad_batch_to_multiple_matches_jax():
    """The port's ``pad_batch_to_multiple`` equals the JAX package's: the
    same wrapped arrays and ``valid`` mask (bit for bit), the batch itself
    where the multiple divides it; ``split_batch`` cuts contiguous equal
    shares and refuses an uneven split."""
    rng = np.random.default_rng(5)
    batch = {"imgs": rng.standard_normal((3, 2, 4, 4, 3)).astype(np.float32),
             "proj_matrices": {"stage1": rng.standard_normal((3, 2, 2, 4, 4)).astype(np.float32)},
             "depth_values": rng.uniform(1, 2, (3, 8)).astype(np.float32)}
    for mult in (2, 4, 8):
        got, want = pad_batch_to_multiple(batch, mult), jax_pad_batch_to_multiple(batch, mult)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert pad_batch_to_multiple(batch, 3) is batch
    padded = pad_batch_to_multiple(batch, 4)
    halves = [split_batch(padded, r, 2) for r in range(2)]
    np.testing.assert_array_equal(halves[1]["imgs"], padded["imgs"][2:])
    np.testing.assert_array_equal(halves[0]["valid"], [1.0, 1.0])
    np.testing.assert_array_equal(halves[1]["valid"], [1.0, 0.0])
    with pytest.raises(ValueError, match="split"):
        split_batch(batch, 0, 2)


class _Indexed:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


def test_loader_rank_shares_cover_the_host_batch():
    """A host's ranks (``rank_in_host`` of ``ranks_in_host``) load the
    contiguous shares of the one-rank loader's batches, in order; with
    ``drop_last=False`` the trailing batch is wrapped up to the ranks
    (``pad_batch_to_multiple``), each share with its ``valid`` mask, with
    threads as without; a batch size they do not divide raises; one process
    is rank 0 of 1 and its helpers are no-ops."""
    whole = [b["i"] for b in DataLoader(_Indexed(), 6, shuffle=True, drop_last=True,
                                        num_workers=0, seed=3)]
    shares = [[b["i"] for b in DataLoader(_Indexed(), 6, shuffle=True, drop_last=True,
                                          num_workers=0, seed=3, rank_in_host=r,
                                          ranks_in_host=3)] for r in range(3)]
    for k, batch in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([s[k] for s in shares]), batch)
    # 5 samples in batches of 4 over 2 ranks: 4, then 1 padded to 2 (the
    # sample twice, valid 1 then 0)
    ds = [{"i": np.asarray(i)} for i in range(5)]
    for workers in (0, 2):
        got = [list(DataLoader(ds, 4, num_workers=workers, rank_in_host=r, ranks_in_host=2))
               for r in range(2)]
        assert [len(g) for g in got] == [2, 2]
        np.testing.assert_array_equal(got[0][0]["i"], [0, 1])
        np.testing.assert_array_equal(got[1][0]["i"], [2, 3])
        assert all("valid" not in g[0] for g in got)
        np.testing.assert_array_equal(got[0][1]["i"], [4])
        np.testing.assert_array_equal(got[1][1]["i"], [4])
        np.testing.assert_array_equal(got[0][1]["valid"], [1.0])
        np.testing.assert_array_equal(got[1][1]["valid"], [0.0])
    with pytest.raises(ValueError, match="split"):
        DataLoader(_Indexed(), 6, drop_last=True, ranks_in_host=4)
    assert reduce_scalars_across_hosts({"a": 2}) == {"a": 2.0}
    assert HostMesh().device("cpu") == torch.device("cpu")


def test_new_modules_are_in_the_import_scans():
    """The JAX-free scans of tests/test_torch_port_ops.py (AST, and a fresh
    interpreter importing every module) cover the modules that the
    multi-card, space, debug and data paths added."""
    from test_torch_port_ops import PORT, REPO as OPS_REPO, _port_sources

    names = {str(f.relative_to(OPS_REPO / PORT)) for f in _port_sources()
             if f.name != "chip_smoke.py"}
    assert {"parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
            "utils/debug.py", "data/tanks.py", "data/eth3d.py", "eval/pcd_metrics.py",
            "eval/viz.py"} <= names


@pytest.mark.parametrize("dp_impl", ["gspmd", "shard_map"])
def test_world_one_data_parallel_step_is_the_bare_step(dp_impl, tmp_path):
    """``checks.check_ddp_step`` on a gloo group of one rank (a ``file://``
    store, this process): two float32 steps through ``data_parallel``
    against the bare ``TrainStep`` from the same seed. On the CPU every
    kernel's plain version is deterministic: the bare runs have no noise,
    so the first step's gradients, the losses, the parameters and the
    BatchNorm running statistics after each step are equal bit for bit,
    and the first update is Adam's on those gradients, bit for bit."""
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        cfg = checks.small_step_model().cfg
        out = checks.check_ddp_step(
            "cpu",
            lambda: MVS4Net(cfg, device="cpu", generator=torch.Generator().manual_seed(3)),
            checks.small_step_batch("cpu"), 2, dp_impls=(dp_impl,))
    finally:
        dist.destroy_process_group()
    (run,) = out["impls"]
    assert all(losses == run["losses"] for losses in out["bare_losses"])
    assert run["gaps"] == {"grads": 0.0, "params_last": 0.0, "bn_stats_last": 0.0,
                           "losses": [0.0]}
    assert out["noise"]["grads"] == 0.0 and run["worst_grad_tensor"]["gap"] == 0.0
    assert run["first_update_vs_replayed_adam"] == 0.0


def _broken_reduction(kind: str):
    """``parallel.mesh.data_parallel`` with a DDP communication hook that
    breaks the gradients' reduction: ``zero`` them, ``half`` them, scale
    them by ``1.01``, or ``roll`` each bucket by one entry (every
    gradient's entries moved to their neighbour's place)."""
    from unittest import mock

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel import mesh

    def hook(state, bucket):
        buf = bucket.buffer()
        if kind == "roll":
            buf.copy_(buf.roll(1))
        else:
            buf.mul_({"zero": 0.0, "half": 0.5, "1.01": 1.01}[kind])
        fut = torch.futures.Future()
        fut.set_result(buf)
        return fut

    real = mesh.data_parallel

    def data_parallel(step, dp_impl="gspmd", *, device=None):
        real(step, dp_impl, device=device)
        step.dp.runner.register_comm_hook(None, hook)
        return step

    return mock.patch.object(mesh, "data_parallel", data_parallel)


@pytest.mark.parametrize("kind", ["zero", "half", "roll"])
def test_world_one_ddp_check_fails_on_a_broken_reduction(kind, tmp_path):
    """``checks.check_ddp_step`` raises where DDP's reduction zeroes, halves
    or moves the gradients (``_broken_reduction``): one float32 step on a
    gloo group of one rank, where Adam's update alone would hide a halved
    gradient."""
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        cfg = checks.small_step_model().cfg
        with _broken_reduction(kind), pytest.raises(AssertionError, match="gradient|grads"):
            checks.check_ddp_step(
                "cpu",
                lambda: MVS4Net(cfg, device="cpu", generator=torch.Generator().manual_seed(3)),
                checks.small_step_batch("cpu"), 1, dp_impls=("gspmd",))
    finally:
        dist.destroy_process_group()


def test_train_cli_under_torchrun_on_two_gloo_ranks(tmp_path):
    """The train CLI under ``torchrun --standalone --nproc_per_node 2``
    with ``--device cpu`` (two gloo ranks, ``--dp_impl gspmd``) on 3
    synthetic scenes at batch 2: one train step (the host batch of 2 split
    one sample a rank), validation of a full batch and of a trailing
    batch of 1 padded to the ranks; rank 0 alone writes the records and
    the checkpoint. A batch of 3, which the two ranks of the host cannot
    split, makes every rank exit with an error."""
    import json

    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m",
            "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli.train",
            "--device", "cpu", "--dataset", "synthetic", "--trainpath", "synthetic://64x64/3",
            "--train_nviews", "3", "--test_nviews", "3", "--epochs", "1", "--summary_freq", "1",
            "--dataloader_workers", "0", "--group_cor", "--inverse_depth"]
    res = subprocess.run(base + ["--batch_size", "2", "--logdir", str(tmp_path / "ok")],
                         env=env, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    records = [json.loads(line) for line in open(tmp_path / "ok" / "metrics.jsonl")]
    assert [(r["mode"], r["step"]) for r in records] == [
        ("train", 0), ("test", 0), ("test", 1), ("fulltest", 1)]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert sorted(os.listdir(tmp_path / "ok")).count("model_00.ckpt") == 1
    bad = subprocess.run(base + ["--batch_size", "3", "--logdir", str(tmp_path / "bad")],
                         env=env, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    assert bad.returncode != 0 and "does not split" in bad.stdout + bad.stderr
