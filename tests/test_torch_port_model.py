"""The whole eval forward: the PyTorch port's ``MVS4Net`` against the JAX
``MVS4Net`` on the CPU, with one set of seeded random weights and BatchNorm
statistics carried across by the port's ``utils/jax_params.py``, and the
port's ``state_dict`` carried back by the JAX package's
``utils/torch_port.py``.

The JAX side runs ``warp_impl="gather"`` (exact sampling) with the fused
top-down and packed convs off; its variables come from ``jax.eval_shape``
of the init (the shapes only) filled with numpy values, which skips the
slow op-by-op JAX init.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.utils.torch_port import (
    torch_state_dict_to_flax,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)

# 64 x 128: the smallest non-square input whose 1/8 stage still halves
# three times in reg2d (stage 1 is 8 x 16)
B, V, H, W = 1, 3, 64, 128


def _cfg(dtype):
    return JaxModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
        mono=True, attn_temp=2.0, dtype=dtype, remat=False,
        warp_impl="gather", fused_topdown=False, pack_conv=False,
    )


def _jax_inputs(batch):
    return (jnp.asarray(batch["imgs"]),
            {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
            jnp.asarray(batch["depth_values"]))


def _variables(jnet, batch, seed=0):
    """Seeded numpy variables in the shape of the JAX init: conv kernels
    ~ N(0, 1/fan_in), BatchNorm scale and running variance in [0.5, 2],
    biases and running means ~ N(0, 0.2)."""
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0), *_jax_inputs(batch), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def scene():
    return batch_samples([make_plane_scene(V=V, H=H, W=W, seed=0)])


def _run_both(scene, dtype):
    """Both networks on the scene. Returns the JAX and port outputs as
    float32 numpy, the variables, the port, and per stage the port's
    ``Σ_D score`` (captured from its reg2d outputs)."""
    jcfg = _cfg(dtype)
    jnet = JaxMVS4Net(jcfg)
    vs = _variables(jnet, scene)
    jout = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jnet.apply(vs, *_jax_inputs(scene), train=False))
    port = MVS4Net(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs))
    score_sums = []
    hooks = [
        reg.register_forward_hook(
            lambda m, i, o, d=port.cfg.ndepths[s]: score_sums.append(
                o.float().reshape(-1, d, *o.shape[1:]).sum(1).numpy()))
        for s, reg in enumerate(port.reg)
    ]
    t = batch_to_torch(scene, "cpu")
    with torch.inference_mode():
        out = port(t["imgs"], t["proj_matrices"], t["depth_values"])
    for h in hooks:
        h.remove()
    out = {s: {k: v.float().numpy() for k, v in o.items()} for s, o in out.items()}
    return jout, out, vs, port, score_sums


def test_eval_forward_matches_jax_float32(scene):
    """float32, per stage:
    - ``attn_weight`` within atol 1e-4;
    - the photometric confidence within atol 1e-4 where |Σ_D score| > 0.1
      (max/Σ is ill-conditioned where the sum nears zero);
    - the depth equal (to the hypotheses' float32 rounding, rtol 1e-5) at
      >= 99% of pixels: argmax near-ties may flip;
    - the mono features (the reference view's FPN output) within 1e-4."""
    jout, out, _, _, score_sums = _run_both(scene, "float32")
    for s in range(1, 5):
        j, p = jout[f"stage{s}"], out[f"stage{s}"]
        for k in ("depth", "photometric_confidence", "hypo_depth", "attn_weight",
                  "inverse_min_depth", "inverse_max_depth", "mono_feat"):
            assert p[k].shape == j[k].shape, (s, k)
        np.testing.assert_allclose(p["attn_weight"], j["attn_weight"], atol=1e-4,
                                   err_msg=f"stage{s} attn_weight")
        np.testing.assert_allclose(p["mono_feat"], j["mono_feat"], atol=1e-4,
                                   err_msg=f"stage{s} mono_feat")
        well = np.abs(score_sums[s - 1]) > 0.1
        assert well.mean() > 0.9, (s, well.mean())
        np.testing.assert_allclose(
            p["photometric_confidence"][well], j["photometric_confidence"][well],
            atol=1e-4, err_msg=f"stage{s} confidence")
        same = np.isclose(p["depth"], j["depth"], rtol=1e-5, atol=0)
        assert same.mean() >= 0.99, (s, same.mean())


def test_eval_forward_bf16_statistically_close(scene):
    """bfloat16: the two frameworks round at other places, and a rounding
    flip at an argmax near-tie moves a pixel by whole hypothesis bins, so
    only the distribution is held: per stage the median |Δdepth| stays
    under 0.5% of the 425..935 depth range, and all depths are finite."""
    jout, out, _, _, _ = _run_both(scene, "bfloat16")
    for s in range(1, 5):
        j, p = jout[f"stage{s}"]["depth"], out[f"stage{s}"]["depth"]
        assert np.isfinite(p).all()
        assert np.median(np.abs(p - j)) <= 0.005 * (935.0 - 425.0), s


def test_state_dict_round_trip_to_flax(scene):
    """The port's ``state_dict`` goes back through the JAX package's own
    reference -> flax transplant and gives the JAX variables it came from.
    The mono decoder is train-only and absent from an eval template, so the
    transplant runs with ``mono=False``."""
    jcfg = _cfg("float32")
    jnet = JaxMVS4Net(jcfg)
    vs = _variables(jnet, scene, seed=1)
    port = MVS4Net(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs))
    back = torch_state_dict_to_flax(
        port.state_dict(), vs, dataclasses.replace(jcfg, mono=False))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_vs = dict(jax.tree_util.tree_leaves_with_path(vs))
    assert flat_back.keys() == flat_vs.keys()
    for k, v in flat_vs.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))
