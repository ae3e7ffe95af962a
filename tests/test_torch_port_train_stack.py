"""The port's train stack around the step against the JAX package on the
CPU: checkpoints (round trip, resume, the JAX package reading a port
checkpoint), the image summaries, the train loaders, and the train CLI
(its flags, the DTU recipe's configs, one run through train, resume,
``--mode test`` and ``--mode profile``).

Inputs are made with numpy from a seed, or read from the fixtures that
tests/test_data.py and tests/test_data_variants.py build; tolerances are
stated per test.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.cli import train as jax_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    TrainConfig as JaxTrainConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    parse_lrepochs as jax_parse_lrepochs,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data import (
    find_dataset_def as jax_find_dataset_def,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data.io import (
    save_pfm,
    write_cam_file,
    write_pair_file,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train import load_weights as jax_load_weights
from deep_reconstruction_with_epipolar_lines_mvster_tpu.train.step import (
    image_summaries as jax_image_summaries,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import train as port_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
    LossConfig,
    ModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import find_dataset_def
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import (
    find_latest_checkpoint,
    image_summaries,
    make_optimizer,
    make_schedule,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)

from test_data import _make_dtu_fixture, _write_png

REPO = Path(__file__).resolve().parents[1]
CFG = dict(group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The 64x64 model runs thousands of small operators per step; with a
    thread per core, each waits at an OpenMP barrier for threads that the
    test workers' other processes keep off the cores (20-50x slower under
    ``pytest -n 6`` than alone). Two threads keep the file's time near its
    serial time."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _batch(seed=0, V=2, H=64, W=64):
    return batch_to_torch(batch_samples([make_plane_scene(V=V, H=H, W=W, seed=seed)]), "cpu")


# ------------------------------------------------------------ checkpoints --


def test_checkpoint_round_trip_resumes_the_lr_curve(tmp_path):
    """Two steps, a checkpoint, a fresh model and optimizer restored from
    it: every parameter, buffer and Adam moment equal, the step counter 2
    and the epoch to continue at 4; then two more steps of each run take
    the same learning rates (the schedule at steps 2 and 3, across its
    warmup and a milestone) and end at the same weights, bit for bit."""
    batch = _batch()
    sched = make_schedule("MS", 1e-3, milestones_iters=[1, 3], gamma=0.5, warmup_iters=2)

    def state(seed):
        model = MVS4Net(ModelConfig(**CFG), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
        return make_train_step(model, LossConfig(inverse_depth=True),
                               make_optimizer(model, 1e-4), sched)

    run = state(0)
    run(batch)
    run(batch)
    path = save_checkpoint(str(tmp_path), 3, run)
    assert path.endswith("model_03.ckpt") and find_latest_checkpoint(str(tmp_path)) == path
    assert not os.path.exists(path + ".tmp")
    resumed = state(1)
    assert restore_checkpoint(path, resumed) == 4 and resumed.step == 2
    for (k, a), b in zip(run.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = run.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    for step in (2, 3):
        run(batch)
        resumed(batch)
        lrs = {float(g["lr"])
               for g in run.optimizer.param_groups + resumed.optimizer.param_groups}
        assert lrs == {sched(step)}
    assert sched(2) != sched(3)
    for (k, a), b in zip(run.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), k


def _jax_template(jcfg, seed=0):
    """The flax variables of a train-mode init of ``jcfg`` with the shapes
    of its init, filled with seeded numpy values (no JAX init run)."""
    batch = batch_samples([make_plane_scene(V=2, H=64, W=64, seed=0)])
    shapes = jax.eval_shape(lambda: JaxMVS4Net(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["imgs"]),
        jax.tree_util.tree_map(jnp.asarray, batch["proj_matrices"]),
        jnp.asarray(batch["depth_values"]), train=True))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                  shapes)


def test_jax_load_weights_reads_a_port_checkpoint(tmp_path):
    """A port checkpoint is the reference's ``.ckpt`` layout: the JAX
    package's ``load_weights`` reads it through its PyTorch path to the
    port's parameters and BatchNorm statistics, exactly."""
    jcfg = JaxModelConfig(**CFG)
    model = checks.seeded_model(ModelConfig(**CFG), 5, "cpu")
    opt = make_optimizer(model)
    path = save_checkpoint(str(tmp_path), 0, make_train_step(
        model, LossConfig(), opt, lambda s: 1e-3))
    vs = jax_load_weights(path, _jax_template(jcfg), model_cfg=jcfg)
    got = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, dict(vs)))
    want = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_image_summaries_match_jax():
    """The TensorBoard image set of batch element 0 against JAX
    ``image_summaries``: the same keys, float16, equal."""
    batch = _batch(seed=3, V=3, H=32, W=48)
    depth = batch["depth"]["stage4"] + torch.from_numpy(
        np.random.default_rng(0).normal(0, 3, (1, 32, 48)).astype(np.float32))
    got = image_summaries({"stage4": {"depth": depth}}, batch)
    jb = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), batch)
    want = jax_image_summaries({"stage4": {"depth": jnp.asarray(depth.numpy())}}, jb)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float16
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


# ---------------------------------------------------------------- loaders --


def _assert_same(a, b, where=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def _make_blender_fixture(root, n_views=3, n_lights=3):
    """The layout tests/test_data_variants.py builds for the Blender loader."""
    rng = np.random.default_rng(0)
    scan = "scene001"
    write_pair_file(f"{root}/pair.txt",
                    [(v, [s for s in range(n_views) if s != v]) for v in range(n_views)])
    os.makedirs(f"{root}/Cameras_512x640", exist_ok=True)
    K = np.array([[1446.2, 0, 331.6], [0, 1441.6, 266.8], [0, 0, 1]], np.float32)
    for v in range(n_views):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = 3.0 * v
        write_cam_file(f"{root}/Cameras_512x640/{v:0>8}_cam.txt", E, K, [425.0, 2.5])
        for light in range(n_lights):
            _write_png(f"{root}/Rectified_512x640/{scan}/rect_C{v:0>3}_L{light:0>2}.png",
                       (512, 640), rng)
        _write_png(f"{root}/Depths_512x640/{scan}/depth_mask_{v:0>3}.png", (512, 640), rng,
                   gray=True)
        save_pfm(f"{root}/Depths_512x640/{scan}/depth_map_{v:0>3}.pfm",
                 rng.uniform(450, 900, (512, 640)).astype(np.float32))
    with open(f"{root}/train.txt", "w") as f:
        f.write(scan + "\n")
    return root


def _make_blendedmvs_fixture(root, n_views=4):
    """A BlendedMVS scan: 384x288 images and depth maps (the loader resizes
    them to 768x576), cams with an explicit depth range, a pair file."""
    from PIL import Image

    rng = np.random.default_rng(1)
    scan = "5a3ca9cb270f8b0c1d2e3f40"
    os.makedirs(f"{root}/{scan}/blended_images", exist_ok=True)
    os.makedirs(f"{root}/{scan}/rendered_depth_maps", exist_ok=True)
    os.makedirs(f"{root}/{scan}/cams", exist_ok=True)
    write_pair_file(f"{root}/{scan}/cams/pair.txt",
                    [(v, [s for s in range(n_views) if s != v]) for v in range(n_views)])
    K = np.array([[300.0, 0, 192.0], [0, 300.0, 144.0], [0, 0, 1]], np.float32)
    for v in range(n_views):
        E = np.eye(4, dtype=np.float32)
        E[:3, 3] = [2.0 * v, 0.5, 1.0]
        write_cam_file(f"{root}/{scan}/cams/{v:0>8}_cam.txt", E, K, [420.0, 2.6, 192, 920.0])
        Image.fromarray(rng.integers(0, 255, (288, 384, 3), dtype=np.uint8)).save(
            f"{root}/{scan}/blended_images/{v:0>8}.jpg")
        save_pfm(f"{root}/{scan}/rendered_depth_maps/{v:0>8}.pfm",
                 rng.uniform(380, 960, (288, 384)).astype(np.float32))
    with open(f"{root}/list.txt", "w") as f:
        f.write(scan + "\n")
    return root


@pytest.fixture(scope="module")
def loader_roots(tmp_path_factory):
    return {
        "dtu": _make_dtu_fixture(str(tmp_path_factory.mktemp("dtu"))),
        "blender": _make_blender_fixture(str(tmp_path_factory.mktemp("bds"))),
        "blendedmvs": _make_blendedmvs_fixture(str(tmp_path_factory.mktemp("bmvs"))),
    }


def _loader_pairs(name, roots):
    """(mode, args, kwargs) of each dataset the test builds in both
    packages: train with robust training (view subsets, scale, color
    jitter) and val."""
    if name == "dtu_yao4":
        r = roots["dtu"]
        return [("train", (r, f"{r}/train.txt", "train", 3, 1.06), dict(rt=True, seed=3)),
                ("val", (r, f"{r}/train.txt", "val", 3, 1.06), dict(seed=3))]
    if name == "blender4":
        r = roots["blender"]
        return [("train", (r, f"{r}/train.txt", "train", 3, 1.34),
                 dict(rt=True, Nlights="2:3", seed=4)),
                ("val", (r, f"{r}/train.txt", "val", 3, 1.34), dict(Nlights="2:3", seed=4))]
    if name == "blendedmvs":
        r = roots["blendedmvs"]
        return [("train", (r, f"{r}/list.txt", "train", 3), dict(robust_train=True, seed=5)),
                ("val", (r, f"{r}/list.txt", "val", 3), dict(robust_train=False, seed=5))]
    return [("train", ("synthetic://32x48/3", None, "train", 3), dict(seed=2))]


@pytest.mark.parametrize("name", ["dtu_yao4", "blender4", "blendedmvs", "synthetic"])
def test_train_loaders_match_jax(name, loader_roots):
    """Each train loader of the port against the JAX package's on the same
    files (the DTU fixture of tests/test_data.py, the Blender layout of
    tests/test_data_variants.py, a small BlendedMVS scan, the synthetic
    plane scenes): every array of the sample equal, at the first, a middle
    and the last index, in epochs 0 and 1 (the per-sample generator of the
    color jitter and the robust view selection)."""
    for mode, args, kwargs in _loader_pairs(name, loader_roots):
        port = find_dataset_def(name)(*args, **kwargs)
        ref = jax_find_dataset_def(name)(*args, **kwargs)
        assert len(port) == len(ref) > 1
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in sorted({0, len(ref) // 2, len(ref) - 1}):
                _assert_same(port[i], ref[i], f"{name} {mode} epoch {epoch} [{i}]")


def test_dataset_registry():
    """The reference's names and the short ones map to the same loaders as
    in the JAX package, tanks and eth3d included
    (tests/test_torch_port_debug_data.py holds those two against JAX's)."""
    for a, b in (("dtu_yao4", "dtu"), ("blender4", "blender"), ("dataloader_eval", "eval")):
        assert find_dataset_def(a) is find_dataset_def(b)
    assert find_dataset_def("dataloader_eval").__name__ == "EvalDataset"
    assert find_dataset_def("tanks").__name__ == "TanksDataset"
    assert find_dataset_def("eth3d").__name__ == "ETH3DDataset"
    with pytest.raises(KeyError):
        find_dataset_def("kitti")


# -------------------------------------------------------------------- CLI --

# the fields that choose how the TPU lays out work: the port ignores them
LAYOUT_FIELDS = {"remat", "warp_impl", "warp_band", "warp_tile_rows", "warp_xband",
                 "warp_tile_cols", "pack_conv", "fused_topdown", "fused_topdown_chain",
                 "fuse_warp_cor", "kernel_coords", "cw_stage_features", "fuse_attn",
                 "d_pack_mids"}


def _options(parser):
    return {o for a in parser._actions for o in a.option_strings}


def test_train_cli_takes_every_jax_flag():
    """Every option string of the JAX train CLI parses in the port's."""
    missing = _options(jax_cli.build_parser()) - _options(port_cli.build_parser())
    assert not missing, sorted(missing)


def _recipe_argv():
    """The arguments scripts/train_dtu.sh passes to the train CLI."""
    text = (REPO / "scripts" / "train_dtu.sh").read_text()
    body = text.split("python train_mvs4.py \\")[1].split("$PY_ARGS")[0]
    return shlex.split(body.replace("\\\n", " "))


def test_train_cli_recipe_configs_match_jax():
    """scripts/train_dtu.sh's arguments give the port the JAX CLI's model,
    loss and train config field for field, apart from the TPU layout
    fields the port ignores."""
    argv = _recipe_argv()
    assert "--bf16" in argv and "--group_cor" in argv
    jargs = jax_cli.build_parser().parse_args(argv)
    pargs = port_cli.build_parser().parse_args(argv)
    jm = dataclasses.asdict(jax_cli.make_model_config(jargs))
    pm = dataclasses.asdict(port_cli.make_model_config(pargs))
    assert jm.keys() == pm.keys()
    assert {k: v for k, v in pm.items() if k not in LAYOUT_FIELDS} == \
        {k: v for k, v in jm.items() if k not in LAYOUT_FIELDS}
    assert dataclasses.asdict(port_cli.make_loss_config(pargs)) == \
        dataclasses.asdict(jax_cli.make_loss_config(jargs))
    milestones, divisor = jax_parse_lrepochs(jargs.lrepochs)
    jt = JaxTrainConfig(
        lr=jargs.lr, weight_decay=jargs.wd, epochs=jargs.epochs, batch_size=jargs.batch_size,
        lr_scheduler=jargs.lr_scheduler, lr_milestones=milestones, lr_gamma_divisor=divisor,
        seed=jargs.seed, summary_freq=jargs.summary_freq, save_freq=jargs.save_freq,
        eval_freq=jargs.eval_freq)
    assert dataclasses.asdict(port_cli.make_train_config(pargs)) == dataclasses.asdict(jt)
    with pytest.raises(ValueError, match="ndepths"):
        port_cli.make_model_config(port_cli.build_parser().parse_args(["--ndepths", "8,8"]))


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_runs_train_resume_test_profile_on_cpu(tmp_path):
    """The port's train CLI on the CPU at ``synthetic://64x64/2`` (B1, V2,
    the DTU recipe's model and loss in bf16): one epoch writes
    ``model_00.ckpt`` and the ``train``/``test``/``fulltest`` records;
    ``--resume --epochs 2`` continues at epoch 2 and step 2 on the same
    learning-rate curve; ``--mode test`` averages the validation scalars;
    ``--mode profile`` writes a Chrome trace. Losses are finite."""
    logdir = str(tmp_path / "run")
    base = ["--device", "cpu", "--dataset", "synthetic", "--trainpath", "synthetic://64x64/2",
            "--batch_size", "1", "--train_nviews", "2", "--test_nviews", "2",
            "--summary_freq", "1", "--logdir", logdir, "--dataloader_workers", "0",
            "--group_cor", "--group_cor_dim", "8,8,4,4", "--ndepths", "8,8,4,4",
            "--inverse_depth", "--attn_temp", "2", "--mono", "--rt", "--bf16",
            "--l1ce_lw", "0.003,1", "--wd", "1e-4", "--lr", "1e-3", "--seed", "0"]
    state = port_cli.main(base + ["--epochs", "1"])
    assert state.step == 2 and os.path.exists(os.path.join(logdir, "model_00.ckpt"))
    first = _records(logdir)
    assert [(r["mode"], r["step"]) for r in first] == [
        ("train", 0), ("train", 1), ("test", 0), ("test", 1), ("fulltest", 2)]
    state = port_cli.main(base + ["--epochs", "2", "--resume"])
    assert state.step == 4 and os.path.exists(os.path.join(logdir, "model_01.ckpt"))
    recs = _records(logdir)[len(first):]
    assert [(r["mode"], r["step"]) for r in recs if r["mode"] == "train"] == [
        ("train", 2), ("train", 3)]
    sched = make_schedule("MS", 1e-3, milestones_iters=[12, 16, 18], gamma=0.5)
    for r in first + recs:
        assert np.isfinite(r["loss"]), r
        if r["mode"] == "train":
            assert r["lr"] == sched(r["step"]), r
    avg = port_cli.main(base + ["--mode", "test"])
    assert np.isfinite(avg["loss"]) and "thres2mm_error" in avg
    prof = port_cli.main(base + ["--mode", "profile"])
    assert prof["trace"] == os.path.join(logdir, "trace.json")
    with open(prof["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert prof["stats"]["steady_state_s"] > 0
