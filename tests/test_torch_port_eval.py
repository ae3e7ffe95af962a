"""The port's eval pipeline (data files and loaders, depth generation, the
consistency filter and fusion, the eval CLI) against the JAX package on the
CPU.

Inputs are made with numpy from a seed (plane scenes) and handed to both
frameworks; the end-to-end test writes one eval-layout fixture of image and
camera files and runs both CLIs on it with one checkpoint.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.cli import test as jax_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data import eval_loader as jax_eval_loader
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data import io as jax_io
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data import synthetic as jax_synthetic
from deep_reconstruction_with_epipolar_lines_mvster_tpu.eval import fusion as jax_fusion
from deep_reconstruction_with_epipolar_lines_mvster_tpu.eval.ply import read_ply as jax_read_ply
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as port_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import eval_loader, io, synthetic
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.loader import collate
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval import fusion
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
    make_eval_forward,
    run_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.ply import read_ply, write_ply


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _scene_views(V=4, H=32, W=48, noise=0.002, seed=0):
    """Per-view depth maps of a plane scene (the analytic depth with a
    relative noise, so that some pixels fail the consistency test), a
    confidence map, and each view's (K, E)."""
    sc = synthetic.make_plane_scene(V=V, H=H, W=W, seed=seed)
    rng = np.random.default_rng(seed + 1)
    depths = (sc["view_depths"] * (1 + noise * rng.standard_normal((V, H, W)))).astype(np.float32)
    conf = rng.uniform(0, 1, (H, W)).astype(np.float32)
    return depths, conf, sc["intrinsics"], sc["extrinsics"], sc["imgs"]


def test_reproject_and_consistency_match_jax():
    """``reproject`` (all source views at once) and the consistency mask
    against the JAX functions view by view: reprojected depth and
    coordinates to rtol 1e-5 at >= 99% of the pixels and everywhere to
    rtol 1e-5 plus atol 1e-3, masks equal. The exception is the pixels whose
    bilinear sample straddles the source image's edge: the zeros padding
    makes the sampled depth jump by the whole depth (~600) per pixel there,
    so the float32 rounding of the projected coordinates (matmul order,
    ~1e-6 px) moves it by up to ~1e-3."""
    depths, _, K, E, _ = _scene_views()
    ks, es = np.stack([K] * 3), E[1:]
    got = fusion.reproject(_t(depths[0]), _t(K), _t(E[0]), _t(depths[1:]), _t(ks), _t(es))
    mask, rep = fusion.check_geometric_consistency(
        _t(depths[0]), _t(K), _t(E[0]), _t(depths[1:]), _t(ks), _t(es),
        condmask_pixel=1.0, condmask_depth=0.01)
    for s in range(3):
        want = jax_fusion.reproject(*map(jnp.asarray, (depths[0], K, E[0], depths[s + 1], K,
                                                       E[s + 1])))
        for a, b in zip(got, want):
            a, b = a[s].numpy(), np.asarray(b)
            assert np.isclose(a, b, rtol=1e-5, atol=0).mean() >= 0.99
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)
        jm, jr = jax_fusion.check_geometric_consistency(
            *map(jnp.asarray, (depths[0], K, E[0], depths[s + 1], K, E[s + 1])),
            condmask_pixel=1.0, condmask_depth=0.01)
        np.testing.assert_array_equal(mask[s].numpy(), np.asarray(jm))
        np.testing.assert_allclose(rep[s].numpy(), np.asarray(jr), rtol=1e-5, atol=1e-3)
    assert 0.2 < mask.float().mean().item() < 0.98     # both outcomes occur


def test_filter_ref_view_and_fused_points_match_jax():
    """``filter_ref_view`` (the counterpart of the JAX ``vmap`` over source
    views) and ``fused_world_points``: masks equal, fused depth and world
    points to rtol 1e-5, colours equal."""
    depths, conf, K, E, imgs = _scene_views(V=4, H=40, W=64, seed=3)
    cfg = fusion.FusionConfig(photomask=0.3, geomask=2)
    args = (depths[0], conf, K, E[0], list(depths[1:]), [K] * 3, list(E[1:]))
    got = fusion.filter_ref_view(*args, cfg, device="cpu")
    want = jax_fusion.filter_ref_view(*args, jax_fusion.FusionConfig(*cfg))
    for k in ("photo_mask", "geo_mask", "final_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["fused_depth"], want["fused_depth"], rtol=1e-5)
    assert 0.05 < got["final_mask"].mean() < 0.95
    xyz, rgb = fusion.fused_world_points(got["fused_depth"], got["final_mask"], K, E[0], imgs[0],
                                         device="cpu")
    jxyz, jrgb = jax_fusion.fused_world_points(want["fused_depth"], want["final_mask"], K, E[0],
                                               imgs[0])
    np.testing.assert_allclose(xyz, jxyz, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(rgb, jrgb)


def test_data_copies_match_jax(tmp_path):
    """The port's copies of the numpy-only data code give the JAX package's
    results: PFM, cam and pair files written by one are read identically by
    the other, the PLY round-trips, and ``SyntheticEvalDataset`` samples and
    their collation are equal array for array."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 9, (6, 7)).astype(np.float32)
    io.save_pfm(str(tmp_path / "a.pfm"), img)
    np.testing.assert_array_equal(jax_io.read_pfm(str(tmp_path / "a.pfm"))[0], img)
    io.write_cam_file(str(tmp_path / "c.txt"), np.eye(4), np.eye(3) * 2, [1.0, 2.0, 3.0, 4.0])
    for a, b in zip(io.read_cam_file(str(tmp_path / "c.txt")),
                    jax_io.read_cam_file(str(tmp_path / "c.txt"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jax_io.write_pair_file(str(tmp_path / "p.txt"), [(0, [1, 2]), (1, [0])])
    assert io.read_pair_file(str(tmp_path / "p.txt")) == [(0, [1, 2]), (1, [0])]
    xyz = rng.standard_normal((5, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (5, 3)).astype(np.uint8)
    write_ply(str(tmp_path / "p.ply"), xyz, rgb)
    for a, b in zip(read_ply(str(tmp_path / "p.ply")), jax_read_ply(str(tmp_path / "p.ply"))):
        np.testing.assert_array_equal(a, b)

    ds = synthetic.SyntheticEvalDataset(V=3, H=16, W=24)
    jds = jax_synthetic.SyntheticEvalDataset(V=3, H=16, W=24)
    got = collate([ds[i] for i in range(3)])
    want = collate([jds[i] for i in range(3)])
    assert got["filename"] == want["filename"]
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
    for k, v in want["proj_matrices"].items():
        np.testing.assert_array_equal(got["proj_matrices"][k], v)


def test_eval_forward_and_space_flag():
    """``make_eval_forward`` returns the stage-4 depth and confidence and the
    per-stage depths of one batch (``run_forward``, numpy out), the mono
    features with ``mono``; over a device list that is no (data, space)
    layout it raises (tests/test_torch_port_space.py holds the row-sharded
    ``--space`` path itself)."""
    cfg = dataclasses.replace(checks.eval_dtu_config(), mono=True)
    model = checks.seeded_model(cfg, 1, "cpu")
    ds = synthetic.SyntheticEvalDataset(V=3, H=64, W=64)
    out, seconds, shape = run_forward(make_eval_forward(model), collate([ds[0]]), "cpu")
    assert out["depth"].shape == (1, 64, 64) and out["confidence"].shape == (1, 64, 64)
    assert [d.shape for d in out["stage_depths"]] == [(1, 8, 8), (1, 16, 16), (1, 32, 32),
                                                     (1, 64, 64)]
    assert [m.shape for m in out["mono_feats"]] == [(1, 16, 16), (1, 32, 32), (1, 64, 64)]
    assert np.isfinite(out["depth"]).all() and seconds > 0 and shape == (64, 64, 3, 192)
    with pytest.raises(ValueError, match="space"):
        make_eval_forward(model, ["cpu"] * 3, space=2)


# ------------------------------------------------------- the CLI, end to end --


def _eval_fixture(root: Path, V=4, H=64, W=128):
    """An eval-layout (``--dataset_name dtu``) fixture of a plane scene: the
    rectified images, one cam file per view and a pair file."""
    from PIL import Image

    sc = synthetic.make_plane_scene(V=V, H=H, W=W, seed=5)
    (root / "Rectified_raw" / "scan1").mkdir(parents=True)
    (root / "Cameras").mkdir()
    for v in range(V):
        Image.fromarray((sc["imgs"][v] * 255).round().astype(np.uint8)).save(
            root / "Rectified_raw" / "scan1" / f"rect_{v + 1:0>3}_3_r5000.png")
        io.write_cam_file(str(root / "Cameras" / f"{v:0>8}_cam.txt"), sc["extrinsics"][v],
                          sc["intrinsics"], [425.0, (935.0 - 425.0) / 192])
    io.write_pair_file(str(root / "pair.txt"), [(v, [s for s in range(V) if s != v])
                                                for v in range(V)])
    (root / "test.txt").write_text("scan1\n")


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_eval_dataset_matches_jax(tmp_path):
    """The port's ``EvalDataset`` copy reads the fixture as the JAX
    package's does: images, projections, hypotheses and file template."""
    _eval_fixture(tmp_path)
    kw = dict(datapath=str(tmp_path), resolution="", listfile=["scan1"], mode="test",
              nviews=4, interval_scale=1.0, max_h=64, max_w=128, dsname="dtu")
    ds, jds = eval_loader.EvalDataset(**kw), jax_eval_loader.EvalDataset(**kw)
    assert len(ds) == len(jds) == 4
    for i in range(4):
        a, b = ds[i], jds[i]
        assert a["filename"] == b["filename"]
        np.testing.assert_array_equal(a["imgs"], b["imgs"])
        np.testing.assert_array_equal(a["depth_values"], b["depth_values"])
        for k in b["proj_matrices"]:
            np.testing.assert_array_equal(a["proj_matrices"][k], b["proj_matrices"][k])


def test_eval_cli_matches_jax_cli(tmp_path):
    """``python -m ...torch.cli.test --run_gendepth --run_filter`` against
    the JAX package's ``cli/test.py`` on one eval-layout fixture (4 views,
    64x128, float32, the scripts/eval_dtu.sh flags), both loading one
    ``.ckpt`` saved from the port's seeded ``state_dict``: the same artifact
    files, depth maps equal (rtol 1e-5) at >= 99% of each view's pixels, and
    fused and combined point counts within 1% (argmax near-ties may flip a
    pixel's depth and the masks around it)."""
    data = tmp_path / "data"
    data.mkdir()
    _eval_fixture(data)
    ckpt = tmp_path / "model.ckpt"
    model = checks.seeded_model(checks.eval_dtu_config(), 11, "cpu")
    torch.save({"model": model.state_dict()}, ckpt)
    argv = (
        f"--dataset=dataloader_eval --dataset_name=dtu --datapath {data} "
        f"--testlist {data / 'test.txt'} --loadckpt {ckpt} --interval_scale=1.0 "
        "--max_h 64 --max_w 128 --run_gendepth --NviewGen 4 --depthgen_thres 0.3 "
        "--run_filter --NviewFilter 4 --photomask 0.3 --geomask 2 --condmask_pixel 1.0 "
        "--condmask_depth 0.01 --group_cor --group_cor_dim=8,8,4,4 --ndepths=8,8,4,4 "
        "--depth_inter_r=0.5,0.5,0.5,1 --inverse_depth --attn_temp 2 --save_ply "
        "--warp_impl gather --num_worker 0"
    ).split()
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_cli.main(argv + ["--outdir", str(jax_out)])
    port_cli.main(argv + ["--outdir", str(port_out), "--device", "cpu"])

    assert _files(port_out) == _files(jax_out)
    scene_j, scene_p = jax_out / "scan1", port_out / "scan1"
    for v in range(4):
        a = io.read_pfm(str(scene_p / "depth_est" / f"{v:0>8}.pfm"))[0]
        b = jax_io.read_pfm(str(scene_j / "depth_est" / f"{v:0>8}.pfm"))[0]
        assert np.isclose(a, b, rtol=1e-5, atol=0).mean() >= 0.99, v
    n_port = len(read_ply(str(scene_p / "_fused_3Dpts.ply"))[0])
    n_jax = len(jax_read_ply(str(scene_j / "_fused_3Dpts.ply"))[0])
    assert n_jax > 0 and abs(n_port - n_jax) <= 0.01 * n_jax, (n_port, n_jax)
    comb = [int(open(d / "combined.ply").read(200).split("element vertex ")[1].split()[0])
            for d in (scene_p, scene_j)]
    assert comb[1] > 0 and abs(comb[0] - comb[1]) <= 0.01 * comb[1], comb


def test_eval_cli_refuses_what_is_not_ported(tmp_path):
    """``--space`` above the device count (the CPU is one device) raises
    instead of running the windows on fewer devices; the debug flags parse
    (they dump with ``--run_gendepth``, tests/test_torch_port_debug_data.py);
    the TPU layout flags parse and change nothing."""
    base = ["--interval_scale", "1", "--device", "cpu"]
    with pytest.raises(ValueError, match="space"):
        port_cli.main(base + ["--space", "2"])
    port_cli.main(base + ["--debug_model", "1", "--vis_ETA", "--vis_stg_features", "1"])
    args = port_cli.build_parser().parse_args(
        base + ["--warp_impl", "mxu_v3", "--fuse_attn", "--pack_conv", "--warp_band", "12,12,8,8"])
    cfg = port_cli.make_model_config(args)
    assert cfg.fuse_attn and cfg.warp_band == (12, 12, 8, 8)


def test_eval_cli_turns_tf32_off():
    """The CLI's device setup (``config.setup_device``) turns TF32 off for
    cuDNN convolutions and matmuls, so that the float32 default computes in
    float32 on the card; the flags are process-wide and put back after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        port_cli.main(["--interval_scale", "1", "--device", "cpu"])
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
