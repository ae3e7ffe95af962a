"""The model variants through the port's entry points on the CPU: the train
CLI with ``--reg_mode reg3d --ASFF`` for one step, the eval CLI with
``--arch_mode fpn_convnext4 --pos_enc 1`` to a fused point cloud, and
``--loadckpt`` of a reference checkpoint into a ``--pos_enc 2`` model (the
reference's checkpoints hold no positional encoding)."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as eval_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import train as train_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import io
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.ply import read_ply
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.checkpoint import load_weights
from test_torch_port_eval import _eval_fixture


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two threads keep the file's time near its serial time under
    ``pytest -n 6`` (``test_torch_port_train_stack.py``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_train_cli_trains_reg3d_with_asff_for_one_step(tmp_path):
    """One epoch of one step on ``synthetic://64x64/1`` (B1, V2, the DTU
    recipe's model and loss in bf16) with ``--reg_mode reg3d --ASFF``: a
    finite loss, a checkpoint with the reg3d and ASFF weights, which
    loads back into the same model."""
    logdir = str(tmp_path / "run")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--trainpath", "synthetic://64x64/1",
            "--batch_size", "1", "--train_nviews", "2", "--test_nviews", "2", "--epochs", "1",
            "--summary_freq", "1", "--logdir", logdir, "--dataloader_workers", "0",
            "--group_cor", "--group_cor_dim", "8,8,4,4", "--ndepths", "8,8,4,4",
            "--inverse_depth", "--attn_temp", "2", "--mono", "--rt", "--bf16",
            "--l1ce_lw", "0.003,1", "--wd", "1e-4", "--lr", "1e-3", "--seed", "0",
            "--reg_mode", "reg3d", "--ASFF"]
    state = train_cli.main(argv)
    assert state.step == 1
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["mode"] for r in records if r["mode"] == "train"] == ["train"]
    assert all(np.isfinite(r["loss"]) for r in records)
    sd = torch.load(os.path.join(logdir, "model_00.ckpt"), map_location="cpu")["model"]
    assert "asff.3.expand.conv.weight" in sd and "reg.0.conv7.0.weight" in sd
    assert sd["reg.0.conv7.0.weight"].shape == (64, 32, 3, 3, 3)
    load_weights(state.model, os.path.join(logdir, "model_00.ckpt"))


def test_eval_cli_runs_convnext4_with_sine_pos_enc_to_a_fused_cloud(tmp_path):
    """``cli.test --run_gendepth --run_filter`` with ``--arch_mode
    fpn_convnext4 --pos_enc 1`` (float32, the scripts/eval_dtu.sh flags) on
    a 4-view 64x128 eval fixture, loading a ``.ckpt`` of that model: every
    view's depth map finite, and the fused PLY and the scene's combined PLY
    written."""
    data = tmp_path / "data"
    data.mkdir()
    _eval_fixture(data)
    cfg = dataclasses.replace(checks.eval_dtu_config(), arch_mode="fpn_convnext4", pos_enc=1)
    ckpt = tmp_path / "model.ckpt"
    torch.save({"model": checks.seeded_model(cfg, 11, "cpu").state_dict()}, ckpt)
    out = tmp_path / "out"
    eval_cli.main((
        f"--dataset=dataloader_eval --dataset_name=dtu --datapath {data} "
        f"--testlist {data / 'test.txt'} --loadckpt {ckpt} --interval_scale=1.0 "
        "--max_h 64 --max_w 128 --run_gendepth --NviewGen 4 --depthgen_thres 0.3 "
        "--run_filter --NviewFilter 4 --photomask 0.3 --geomask 2 --condmask_pixel 1.0 "
        "--condmask_depth 0.01 --group_cor --group_cor_dim=8,8,4,4 --ndepths=8,8,4,4 "
        "--depth_inter_r=0.5,0.5,0.5,1 --inverse_depth --attn_temp 2 --save_ply "
        "--arch_mode fpn_convnext4 --pos_enc 1 --num_worker 0 --device cpu "
        f"--outdir {out}").split())
    scene = out / "scan1"
    for v in range(4):
        depth = io.read_pfm(str(scene / "depth_est" / f"{v:0>8}.pfm"))[0]
        assert depth.shape == (64, 128) and np.isfinite(depth).all(), v
    points = read_ply(str(scene / "_fused_3Dpts.ply"))[0]
    assert np.isfinite(points).all()
    assert (scene / "combined.ply").exists()


def test_load_weights_keeps_fresh_learned_pos_enc_and_warns(tmp_path):
    """A checkpoint of the flagship model (no ``pos_enc.*``, as every
    reference checkpoint) loads into a ``--pos_enc 2`` model: every other
    weight is the checkpoint's, the embeddings stay as drawn, and a
    warning names them."""
    src = MVS4Net(ModelConfig(group_cor=True), device="cpu",
                  generator=torch.Generator().manual_seed(1))
    path = tmp_path / "ref.ckpt"
    torch.save({"model": src.state_dict()}, path)
    model = MVS4Net(ModelConfig(group_cor=True, pos_enc=2), device="cpu",
                    generator=torch.Generator().manual_seed(2))
    fresh = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("pos_enc.")}
    assert len(fresh) == 4
    with pytest.warns(UserWarning, match="positional encoding"):
        load_weights(model, str(path))
    got = model.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
    for k, v in fresh.items():
        assert torch.equal(got[k], v), k


def test_load_weights_still_raises_on_any_other_missing_key(tmp_path):
    src = MVS4Net(ModelConfig(group_cor=True), device="cpu").state_dict()
    del src["reg.2.conv0.conv.weight"]
    path = tmp_path / "partial.ckpt"
    torch.save({"model": src}, path)
    for pos_enc in (0, 2):
        model = MVS4Net(ModelConfig(group_cor=True, pos_enc=pos_enc), device="cpu")
        with pytest.raises(KeyError, match="lacks 1 keys"):
            load_weights(model, str(path))
