"""The PyTorch port's geometry, hypotheses, layers, FPN and aggregation
against the JAX package on the CPU, plus the port's hygiene: no JAX in it,
and its device rule.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are float32: 1e-5..1e-4 absolute where convolutions sum in
another order, tighter where the arithmetic is the same.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry as jg
import deep_reconstruction_with_epipolar_lines_mvster_tpu.core.hypothesis as jh
import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry as tg
import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.hypothesis as th
from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.data import synthetic as jax_synthetic
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import layers as jl
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models.fpn import FPN4 as JaxFPN4
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.warp_cor import (
    epipolar_aggregate as jax_epipolar_aggregate,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import config as port_config
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data import synthetic
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.fpn import FPN4
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.warp_cor import (
    epipolar_aggregate,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import jax_params

REPO = Path(__file__).resolve().parents[1]
PORT = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
JAX_PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _projs(rng, n):
    """``[n, 2, 4, 4]`` stacks: rigid extrinsics (a small rotation and a
    translation) and upper-triangular intrinsics with skew."""
    out = np.zeros((n, 2, 4, 4), np.float32)
    for i in range(n):
        a = rng.normal(0, 0.05, 3)
        kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.linalg.qr(np.eye(3) + kx)[0]
        R *= np.sign(np.diag(R))[None]
        out[i, 0, :3, :3] = R
        out[i, 0, :3, 3] = rng.normal(0, 10, 3)
        out[i, 0, 3, 3] = 1.0
        f = rng.uniform(50, 80)
        out[i, 1, :3, :3] = [[f, rng.normal(0, 0.5), rng.uniform(20, 40)],
                             [0, f * 1.01, rng.uniform(15, 30)], [0, 0, 1]]
    return out


# ----------------------------------------------------------------- config --


def test_config_accepts_jax_config_fields():
    """A JAX config's ``asdict`` builds the port's config: same field names,
    same values, and a torch dtype."""
    jcfg = JaxModelConfig(group_cor=True, inverse_depth=True, mono=True,
                          dtype="bfloat16", warp_impl="mxu_v3", pack_conv=True)
    cfg = port_config.ModelConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.torch_dtype is torch.bfloat16
    assert cfg.fpn_out_channels == jcfg.fpn_out_channels


def test_default_device_is_the_card():
    """``device=None`` means CUDA; without it the entry raises instead of
    running on the CPU, and the CPU has to be asked for."""
    assert port_config.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert port_config.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_config.resolve_device()


# --------------------------------------------------------------- geometry --


def test_projection_algebra_matches_jax():
    """compose_projection, the analytic inverses and relative_projection:
    the same float32 formulas (atol 1e-5 on entries up to ~1e3, rtol 1e-6)."""
    rng = np.random.default_rng(0)
    src, ref = _projs(rng, 3), _projs(rng, 3)
    pairs = [
        (tg.compose_projection(_t(src)), jg.compose_projection(jnp.asarray(src))),
        (tg.intrinsics_inverse(_t(src[:, 1, :3, :3])),
         jg.intrinsics_inverse(jnp.asarray(src[:, 1, :3, :3]))),
        (tg.extrinsics_inverse(_t(src[:, 0])), jg.extrinsics_inverse(jnp.asarray(src[:, 0]))),
        (tg.relative_projection(_t(src), _t(ref)),
         jg.relative_projection(jnp.asarray(src), jnp.asarray(ref))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-6)


def test_warp_coords_and_grid_sample_match_jax():
    """Plane-sweep coordinates (atol 1e-3 px at |x| ~ 1e2: float32
    rounding of the einsum against explicit products) and the zero-padded
    bilinear sample at coordinates inside, across and far outside the
    image (atol 1e-5)."""
    rng = np.random.default_rng(1)
    B, D, H, W, C = 2, 3, 12, 16, 5
    rel = np.asarray(jg.relative_projection(jnp.asarray(_projs(rng, B)),
                                            jnp.asarray(_projs(rng, B))))
    hypo = rng.uniform(400, 900, (B, D, H, W)).astype(np.float32)
    gx, gy = tg.warp_coords_xy(_t(rel), _t(hypo))
    jx, jy = jg.warp_coords_xy(jnp.asarray(rel), jnp.asarray(hypo))
    np.testing.assert_allclose(_np(gx), np.asarray(jx), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(_np(gy), np.asarray(jy), atol=1e-3, rtol=1e-5)

    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    coords = rng.uniform(-3, 19, (B, 7, 9, 2)).astype(np.float32)
    coords[0, 0, :4] = [[np.nan, 2.0], [3e9, 1.0], [-3e9, -3e9], [W - 1, H - 1]]
    got = _np(tg.grid_sample_2d(_t(img), _t(coords)))
    want = np.array(jg.grid_sample_2d(jnp.asarray(img), jnp.asarray(coords)))
    # a NaN coordinate samples nothing here (0); JAX propagates the NaN
    np.testing.assert_array_equal(got[0, 0, 0], 0.0)
    got[0, 0, 0] = want[0, 0, 0] = 0.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,out_hw", [((2, 5, 7, 3), (10, 14)),
                                          ((1, 4, 1, 2), (8, 3)),
                                          ((3, 6, 6, 1), (6, 6))])
def test_resize_and_nearest_match_jax(shape, out_hw):
    """Align-corners resize (two taps, float64 tables rounded once, i0
    clamped at n_in-2) and the nearest x2 upsample: atol 1e-6 (the
    interpolation matrix product against explicit taps)."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(
        _np(tg.resize_align_corners(_t(x), out_hw)),
        np.asarray(jg.resize_align_corners(jnp.asarray(x), out_hw)), atol=1e-6)
    np.testing.assert_array_equal(
        _np(tg.upsample_nearest_2x(_t(x))), np.asarray(jg.upsample_nearest_2x(jnp.asarray(x))))


def test_hypotheses_match_jax():
    """init_range, init_inverse_range, schedule_inverse_range and the fixed
    schedule_range: rtol 1e-6 on depths of ~1e3."""
    rng = np.random.default_rng(3)
    dv = np.stack([rng.uniform(400, 450, 2), rng.uniform(900, 950, 2)], 1).astype(np.float32)
    for name in ("init_range", "init_inverse_range"):
        got = getattr(th, name)(_t(dv), 8, 5, 6)
        want = getattr(jh, name)(jnp.asarray(dv), 8, 5, 6)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    inv_min = (1 / rng.uniform(500, 600, (2, 4, 5))).astype(np.float32)
    inv_max = (1 / rng.uniform(700, 800, (2, 4, 5))).astype(np.float32)
    np.testing.assert_allclose(
        _np(th.schedule_inverse_range(_t(inv_min), _t(inv_max), 4, 8, 10)),
        np.asarray(jh.schedule_inverse_range(jnp.asarray(inv_min), jnp.asarray(inv_max), 4, 8, 10)),
        rtol=1e-6)
    cur = rng.uniform(500, 800, (2, 4, 5)).astype(np.float32)
    itv = np.array([2.5, 3.0], np.float32)
    np.testing.assert_allclose(
        _np(th.schedule_range(_t(cur), 4, _t(itv), 8, 10)),
        np.asarray(jh.schedule_range(jnp.asarray(cur), 4, jnp.asarray(itv), 8, 10)),
        rtol=1e-6)


def test_synthetic_scene_matches_jax_package():
    """The port's numpy copy of the plane scene and of batch_samples gives
    the JAX package's arrays bit for bit."""
    samples = [synthetic.make_plane_scene(V=3, H=16, W=24, seed=s) for s in (0, 1)]
    jsamples = [jax_synthetic.make_plane_scene(V=3, H=16, W=24, seed=s) for s in (0, 1)]
    got = synthetic.batch_samples(samples)
    want = jax_synthetic.batch_samples(jsamples)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (p, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))


# ----------------------------------------------------------------- layers --


def _random_variables(module, *args, seed=0, **kwargs):
    """Variables of a flax module with the shapes of its init, filled with
    seeded numpy values (weights ~ N(0, 1/fan_in), BatchNorm affine and
    running statistics away from identity) — no JAX init needed."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _bn_sd(vs, prefix, flax_bn="BatchNorm_0"):
    p, b = vs["params"][flax_bn], vs["batch_stats"][flax_bn]
    return {f"{prefix}weight": _t(p["scale"]), f"{prefix}bias": _t(p["bias"]),
            f"{prefix}running_mean": _t(b["mean"]), f"{prefix}running_var": _t(b["var"]),
            f"{prefix}num_batches_tracked": torch.tensor(0)}


LAYER_CASES = [
    # (name, flax module, port module, input shape, port state_dict builder)
    ("conv3", jl.ConvBnReLU(8, 3), tl.ConvBnReLU(5, 8, 3), (2, 9, 11, 5),
     lambda v: {"conv.weight": _t(jax_params._conv2d(v["params"]["Conv_0"]["kernel"]))}),
    ("conv5_s2", jl.ConvBnReLU(6, 5, stride=2), tl.ConvBnReLU(4, 6, 5, 2), (2, 10, 13, 4),
     lambda v: {"conv.weight": _t(jax_params._conv2d(v["params"]["Conv_0"]["kernel"]))}),
    ("c133", jl.ConvBnReLU3D(8, kernel=(1, 3, 3)), tl.ConvBnReLU3D(4, 8, (1, 3, 3)),
     (6, 8, 10, 4),
     lambda v: {"conv.weight": _t(jax_params._conv3d_as_2d(v["params"]["Conv_0"]["kernel"]))}),
    ("c133_s2", jl.ConvBnReLU3D(16, kernel=(1, 3, 3), stride=(1, 2, 2)),
     tl.ConvBnReLU3D(8, 16, (1, 3, 3), (1, 2, 2)), (6, 8, 10, 8),
     lambda v: {"conv.weight": _t(jax_params._conv3d_as_2d(v["params"]["Conv_0"]["kernel"]))}),
    ("c333", jl.ConvBnReLU3D(8, depth=3), tl.ConvBnReLU3D(8, 8, depth=3), (6, 8, 10, 8),
     lambda v: {"conv.weight": _t(jax_params._conv3d(v["params"]["Conv_0"]["kernel"]))}),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_conv_blocks_match_flax(case):
    """ConvBnReLU (symmetric k//2 padding at stride 1 and 2) and
    ConvBnReLU3D ((1,3,3) folded, strided, and the unfolded 3x3x3) with
    eval BatchNorm, against the flax blocks: atol 1e-5 (conv sum order)."""
    _, jmod, tmod, shape, conv_sd = case
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    vs = _random_variables(jmod, jnp.asarray(x), train=False)
    tmod.load_state_dict({**conv_sd(vs), **_bn_sd(vs, "bn.")})
    want = jmod.apply(vs, jnp.asarray(x), train=False)
    got = tmod.eval()(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_deconv_block_and_batchnorm_match_flax():
    """DeconvBnReLU3D: flax's (1,2)-padded transposed conv equals torch's
    ConvTranspose(k=3, s=2, p=1, output_padding=1) with the kernel flipped
    (an exact x2 upsample); and TorchBatchNorm in bf16 computes in float32
    and casts back. atol 1e-5 (f32) and one bf16 ulp."""
    x = np.random.default_rng(5).standard_normal((4, 5, 7, 16)).astype(np.float32)
    jmod = jl.DeconvBnReLU3D(8)
    vs = _random_variables(jmod, jnp.asarray(x), train=False)
    tmod = tl.DeconvBnReLU3D(16, 8)
    k = vs["params"]["ConvTranspose_0"]["kernel"]
    tmod.load_state_dict({"0.weight": _t(jax_params._deconv3d_as_2d(k)), **_bn_sd(vs, "1.")})
    want = jmod.apply(vs, jnp.asarray(x), train=False)
    got = tmod.eval()(_t(x))
    assert got.shape == (4, 10, 14, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)

    jbn = jl.TorchBatchNorm(dtype=jnp.bfloat16)
    bvs = _random_variables(jbn, jnp.asarray(x), use_running_average=True, seed=6)
    tbn = tl.TorchBatchNorm(16).eval()
    tbn.load_state_dict(_bn_sd({k: {"BatchNorm_0": v} for k, v in bvs.items()}, ""))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jbn.apply(bvs, xb, use_running_average=True)
    got = tbn(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=2.0 ** -7 * np.abs(np.asarray(want, np.float32)).max())


def test_fpn4_matches_flax():
    """The FPN (stem + the three top-down levels through K2's plain
    version + out1) against the JAX FPN4 with the unfused top-down chain:
    atol 1e-4 on O(1) features (conv sum order through 14 layers)."""
    x = np.random.default_rng(7).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    jmod = JaxFPN4(8)
    vs = _random_variables(jmod, jnp.asarray(x), False, seed=8)
    sd = jax_params.jax_variables_to_state_dict(
        {col: {"FPN4_0": tree} for col, tree in vs.items()}, num_stages=0)
    port = FPN4(8).eval()
    port.load_state_dict({k[len("feature."):]: v for k, v in sd.items()})
    want = jmod.apply(vs, jnp.asarray(x), False)
    got = port(_t(x))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4, rtol=1e-4,
                                   err_msg=f"o{i + 1}")


@pytest.mark.parametrize("group_cor,attn_fuse_d", [(True, True), (True, False), (False, True)])
def test_epipolar_aggregate_matches_jax(group_cor, attn_fuse_d):
    """Cross-view aggregation over 3 views (group correlation through K1's
    plain version, or the squared difference), both attention forms,
    against JAX ``impl="gather"``: atol 1e-5 on the folded
    ``[B*D, H, W, G]`` volume."""
    rng = np.random.default_rng(9)
    B, D, H, W, C, G = 2, 4, 16, 24, 8, 4
    batch = synthetic.batch_samples(
        [synthetic.make_plane_scene(V=3, H=H, W=W, seed=i) for i in range(B)])
    projs = batch["proj_matrices"]["stage4"]
    feats = [rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(3)]
    hypo = np.broadcast_to(np.linspace(425, 935, D, dtype=np.float32)[None, :, None, None],
                           (B, D, H, W)).copy()
    kw = dict(group_cor=group_cor, group_dim=G, attn_temp=2.0, attn_fuse_d=attn_fuse_d)
    want = jax_epipolar_aggregate([jnp.asarray(f) for f in feats], jnp.asarray(projs),
                                  jnp.asarray(hypo), impl="gather", **kw)
    got = epipolar_aggregate([_t(f) for f in feats], _t(projs), _t(hypo), **kw)
    assert got.shape == (B * D, H, W, G if group_cor else C)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- hygiene --


def _port_sources():
    files = sorted((REPO / PORT).rglob("*.py"))
    names = {str(f.relative_to(REPO / PORT)) for f in files}
    # the train path's modules are among them
    assert {"ops/warp.py", "ops/topdown_chain.py", "ops/kernels/warp_bwd.py",
            "models/mono.py", "core/sinkhorn.py", "models/losses.py",
            "train/metrics.py", "train/schedule.py", "train/step.py"} <= names
    return files + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".") for m in ("jax", "jaxlib", "flax", JAX_PKG))


def test_port_sources_import_no_jax():
    """AST scan of the port and chip_smoke.py: no import of JAX, flax or
    the JAX package, at any level of any function."""
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port and
    chip_smoke.py; neither JAX nor the JAX package may end up in
    ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PORT} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        f"('jax', 'jaxlib', 'flax', '{JAX_PKG}')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
