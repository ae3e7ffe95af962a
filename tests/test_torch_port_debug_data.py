"""The port's debug dumps (``utils/debug.py``), its Tanks&Temples and ETH3D
loaders (``data/tanks.py``, ``data/eth3d.py``) and its point-cloud metrics
and viz helpers (``eval/pcd_metrics.py``, ``eval/viz.py``) against the JAX
package's, on the CPU.

The debug dumps run both frameworks' forward with the same seeded flax
variables (carried to the port by ``utils/jax_params.py``) on a B1 V3
64x64 plane scene; the loaders read ``tests/test_data_variants.py``'s
fixtures; the metrics take ``tests/test_pcd_metrics_viz.py``'s clouds.
Every tolerance is stated.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_data_variants import eth3d_root, tanks_root  # noqa: F401  (fixtures)

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data import (
    find_dataset_def as jax_find_dataset_def,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.eval import pcd_metrics as jax_pcd
from deep_reconstruction_with_epipolar_lines_mvster_tpu.eval import viz as jax_viz
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.utils import debug as jax_debug
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import find_dataset_def
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval import pcd_metrics, viz
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import debug
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)


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
        attn_temp=2.0, dtype="float32", remat=False,
        warp_impl="gather", fused_topdown=False, pack_conv=False,
    )


def test_get_powers_matches_jax():
    for n in (0, 1, 2, 5, 104, 255, 1023):
        assert debug.get_powers(n) == jax_debug.get_powers(n)
    assert debug.get_powers(255) == [str(i) for i in range(8)]


def test_debug_dump_forward_matches_jax(tmp_path):
    """``--debug_model 255`` (every bit) of an eval forward in both
    frameworks: the same ``.npy`` names (185: the input, 117 feature maps
    under the flax module paths, and the per-stage depth, hypotheses,
    attention, logits, warped views and correlation weights), the same
    shapes, float32; each array within 1e-4 of max(1, max|JAX array|)
    (the whole forward agrees to ~1e-5 in float32,
    tests/test_torch_port_model.py), except the depths, which must be equal
    to 1e-5 relative on >= 99% of the pixels (an argmax near-tie may
    flip), and the logits, held where the attention is above 1e-6 (the log
    amplifies the attention's absolute rounding below that). The model's
    train/eval mode and BatchNorm statistics are as before the dump."""
    scene = batch_samples([make_plane_scene(V=3, H=64, W=64, seed=0)])
    jcfg = _cfg()
    jnet = JaxMVS4Net(jcfg)
    jin = (jnp.asarray(scene["imgs"]), {k: jnp.asarray(v) for k, v in
                                        scene["proj_matrices"].items()},
           jnp.asarray(scene["depth_values"]))
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), *jin, train=False))
    rng = np.random.default_rng(3)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    vs = jax.tree_util.tree_map_with_path(fill, shapes)
    want = jax_debug.debug_dump_forward(
        jnet, jax.tree_util.tree_map(jnp.asarray, vs), *jin, bits=255,
        outdir=str(tmp_path / "jax"), train=False)
    port = MVS4Net(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    t = batch_to_torch(scene, "cpu")
    got = debug.debug_dump_forward(port, t["imgs"], t["proj_matrices"], t["depth_values"],
                                   bits=255, outdir=str(tmp_path / "port"), train=False)
    assert sorted(got) == sorted(want) and len(got) == 185
    for name, path in want.items():
        w, g = np.load(path), np.load(got[name])
        assert os.path.basename(got[name]) == os.path.basename(path)
        assert g.shape == w.shape and g.dtype == np.float32, name
        if name.endswith("_depth") and not name.endswith("mono_depth"):
            assert np.isclose(g, w, rtol=1e-5, atol=0).mean() >= 0.99, name
            continue
        if name.endswith("attn_logits"):
            keep = np.exp(w) > 1e-6
            g, w = g[keep], w[keep]
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, name
    # a train-mode dump puts the mode and the BatchNorm statistics back
    debug.debug_dump_forward(port, t["imgs"], t["proj_matrices"], t["depth_values"],
                             bits=1, outdir=str(tmp_path / "train"), train=True)
    assert not port.training
    for k, v in port.state_dict().items():
        assert (v == before[k]).all(), k


def _same_sample(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _same_sample(got[k], w)
        elif isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_tanks_loader_matches_jax(tanks_root):  # noqa: F811
    """The port's Tanks&Temples loader against the JAX package's on
    test_data_variants' fixture: the same metas and, for every sample of
    the scan with images, the same arrays bit for bit."""
    got = find_dataset_def("tanks")(tanks_root, n_views=3, split="intermediate")
    want = jax_find_dataset_def("tanks")(tanks_root, n_views=3, split="intermediate")
    assert got.metas == want.metas and len(got) == 24
    for i in range(3):
        _same_sample(got[i], want[i])


def test_eth3d_loader_matches_jax(eth3d_root):  # noqa: F811
    """The port's ETH3D loader (resize to 320x256) against the JAX
    package's on test_data_variants' fixture: the same metas and samples
    bit for bit, the negative depth_min clamped in both."""
    pytest.importorskip("cv2")
    got = find_dataset_def("eth3d")(eth3d_root, split="test", n_views=3, img_wh=(320, 256))
    want = jax_find_dataset_def("eth3d")(eth3d_root, split="test", n_views=3,
                                         img_wh=(320, 256))
    assert got.metas == want.metas
    for i in range(3):
        _same_sample(got[i], want[i])
    assert got[0]["depth_values"][0] == 1.0


@pytest.mark.parametrize("case", ["identical", "shifted", "incomplete", "max_dist"])
def test_pcd_metrics_match_jax(case):
    """``accuracy_completeness`` on test_pcd_metrics_viz's clouds (and one
    with ``max_dist``) equals the JAX package's, every key, exactly."""
    rng = np.random.default_rng({"identical": 0, "shifted": 1, "incomplete": 2,
                                 "max_dist": 4}[case])
    gt = rng.uniform(-100, 100, (20000, 3))
    pred = {"identical": gt, "shifted": gt + np.array([1.0, 0.0, 0.0]),
            "incomplete": gt[gt[:, 0] < 0], "max_dist": gt + rng.normal(0, 3, gt.shape)}[case]
    kw = {"max_dist": 5.0} if case == "max_dist" else {}
    assert pcd_metrics.accuracy_completeness(pred, gt, tau=2.0, **kw) == \
        jax_pcd.accuracy_completeness(pred, gt, tau=2.0, **kw)
    assert pcd_metrics.accuracy_completeness(pred[:0], gt) == jax_pcd.accuracy_completeness(
        pred[:0], gt)


def test_viz_helpers_match_jax():
    """Every viz helper on test_pcd_metrics_viz's cases equals the JAX
    package's bit for bit: the bin boxes by preset and by dims, the box
    edges, the camera glyphs, the crop, the outlier removal and the voxel
    downsample."""
    for ctx in ("path/to/overhead03_capture", "Merlin_Mario_Set_with_GT/x", "other", None):
        for a, b in zip(viz.bin_bbox_bounds(ctx), jax_viz.bin_bbox_bounds(ctx)):
            np.testing.assert_array_equal(a, b)
    mn, mx, _, _ = viz.bin_bbox_bounds("overhead02")
    np.testing.assert_array_equal(viz.bbox_edge_points(mn, mx), jax_viz.bbox_edge_points(mn, mx))
    E = np.eye(4)
    E[:3, 3] = [0, 0, -500]
    np.testing.assert_array_equal(viz.camera_glyph_points([E, E.T]),
                                  jax_viz.camera_glyph_points([E, E.T]))
    rng = np.random.default_rng(3)
    cloud = np.vstack([rng.normal(0, 1.0, (2000, 3)), rng.uniform(50, 60, (20, 3))])
    np.testing.assert_array_equal(viz.remove_statistical_outliers(cloud),
                                  jax_viz.remove_statistical_outliers(cloud))
    np.testing.assert_array_equal(viz.voxel_downsample(cloud.astype(np.float32), 0.5),
                                  jax_viz.voxel_downsample(cloud.astype(np.float32), 0.5))
    np.testing.assert_array_equal(viz.crop_to_box(cloud, [-1, -1, -1], [1, 1, 1]),
                                  jax_viz.crop_to_box(cloud, [-1, -1, -1], [1, 1, 1]))


@pytest.mark.parametrize("script", ["train_dtu", "train_bds8", "eval_dtu", "eval_bds8",
                                    "eval_bin"])
def test_launch_scripts_parse_with_the_port_clis(script):
    """Each of the port's launch scripts
    (``deep_reconstruction_with_epipolar_lines_mvster_tpu_torch/scripts/``)
    calls the port's CLI (training through ``torchrun``), and its flags
    parse with that CLI's parser into the model configuration of the JAX
    package's script of the same name."""
    import re
    import shlex
    from pathlib import Path

    from deep_reconstruction_with_epipolar_lines_mvster_tpu.cli import test as jax_test_cli
    from deep_reconstruction_with_epipolar_lines_mvster_tpu.cli import train as jax_train_cli
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as test_cli
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import train as train_cli

    repo = Path(__file__).resolve().parents[1]

    def flags(path, entry):
        """The words after ``entry`` on the script's command, each shell
        variable standing for a value."""
        text = path.read_text().replace("\\\n", " ").replace("$PY_ARGS", "")
        line = next(ln for ln in text.splitlines()
                    if entry in ln and ln.lstrip().startswith(("python", "torchrun")))
        words = shlex.split(re.sub(r'"?\$\{?\w+\}?"?', "X", line.split("2>&1")[0]))
        return words[words.index(entry) + 1:]

    port = repo / "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch" / "scripts" / \
        f"{script}.sh"
    train = script.startswith("train")
    module = ("deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli."
              + ("train" if train else "test"))
    text = port.read_text()
    assert module in text and (("torchrun" in text) == train)
    argv = flags(port, module)
    jax_argv = flags(repo / "scripts" / f"{script}.sh",
                     "train_mvs4.py" if train else "test_mvs4.py")
    cli, jax_cli = (train_cli, jax_train_cli) if train else (test_cli, jax_test_cli)
    args = cli.build_parser().parse_args(argv)
    jargs = jax_cli.build_parser().parse_args(jax_argv)
    for name in ("group_cor", "group_cor_dim", "ndepths", "depth_inter_r", "inverse_depth",
                 "attn_temp", "mono", "interval_scale", "batch_size", "bf16"):
        assert getattr(args, name) == getattr(jargs, name), name
