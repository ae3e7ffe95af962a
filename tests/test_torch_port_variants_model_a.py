"""The whole eval forward of every model variant: the PyTorch port's
``MVS4Net`` against the JAX package's on the CPU, and the parameter round
trip JAX -> port -> JAX. This file holds the helpers and the first five
variants of ``checks.VARIANTS``; ``..._model_b.py`` and ``..._model_c.py``
hold the rest (one file runs on one worker).

Each variant is the flagship configuration (group correlation (8,8,4,4),
ndepths (8,8,4,4), inverse depth, attn_temp 2, mono) with its fields
changed, in float32, on a plane scene of two 64x64 views. The JAX side runs
``warp_impl="gather"`` with the fused top-down and packed convs off, under
``jax.jit``; its variables are the shapes of a train-mode init
(``jax.eval_shape``) filled with seeded numpy values
(``test_torch_port_model._variables``), carried to the port by
``utils/jax_params.py`` with the variant's config. Tolerances are
``test_torch_port_model.py``'s, but for the photometric confidence's
(``check_eval_forward``).
"""

from __future__ import annotations

import dataclasses

import jax
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
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.checks import VARIANTS
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
from test_torch_port_model import _jax_inputs, _variables

# beside the one-field variants, two of their combinations: every pyramid
# and head option together with reg2d's CAM mid blocks and the learned
# pos-enc, and with reg3d and the sine pos-enc
FIELDS = {
    **dict(VARIANTS),
    "combined_reg2d": {"arch_mode": "fpn_convnext", "gn": True, "dcn": True, "asff": True,
                       "agg_type": "ConvBnReLU3D_CAM", "pos_enc": 2},
    "combined_reg3d": {"arch_mode": "fpn_convnext4", "dcn": True, "asff": True,
                       "reg_mode": "reg3d", "pos_enc": 1},
}
_SCENE = batch_samples([make_plane_scene(V=2, H=64, W=64, seed=0)])


def jax_config(name: str) -> JaxModelConfig:
    return JaxModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), ndepths=(8, 8, 4, 4), inverse_depth=True,
        mono=True, attn_temp=2.0, dtype="float32", remat=False, warp_impl="gather",
        fused_topdown=False, pack_conv=False, **FIELDS[name])


def port_model(name: str, vs):
    """The port's model of variant ``name`` holding the JAX variables
    ``vs``."""
    cfg = ModelConfig(**dataclasses.asdict(jax_config(name)))
    port = MVS4Net(cfg, device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs, cfg=cfg))
    return port


# the absolute error in each score that the photometric confidence is held
# to (the scores are O(1)-O(10) here)
SCORE_ATOL = 1e-4


def check_eval_forward(name: str) -> None:
    """Per stage: ``attn_weight`` and the mono features (the reference
    view's stage features) within atol 1e-4; the depth equal (rtol 1e-5) at
    >= 99% of pixels; the photometric confidence ``c = max_D(score) /
    Σ_D score`` at every pixel within what an error of ``SCORE_ATOL`` in
    each score moves it by, ``SCORE_ATOL (1 + D|c|) / |Σ_D score|``. (At
    these inputs Σ_D score cancels to well under its terms' magnitude at a
    few percent of pixels of some variants, where a fixed 1e-4 on the
    confidence would hold the scores to 1e-6 and less.)"""
    jcfg = jax_config(name)
    jnet = JaxMVS4Net(jcfg)
    vs = _variables(jnet, _SCENE)
    jout = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(lambda v, *a: jnet.apply(v, *a, train=False))(vs, *_jax_inputs(_SCENE)))
    port = port_model(name, vs)
    score_sums = []
    hooks = [reg.register_forward_hook(
        lambda m, i, o, d=port.cfg.ndepths[s]: score_sums.append(
            o.float().reshape(-1, d, *o.shape[1:]).sum(1).numpy()))
        for s, reg in enumerate(port.reg)]
    t = batch_to_torch(_SCENE, "cpu")
    with torch.inference_mode():
        out = port(t["imgs"], t["proj_matrices"], t["depth_values"])
    for h in hooks:
        h.remove()
    for s in range(1, 5):
        j = jout[f"stage{s}"]
        p = {k: v.float().numpy() for k, v in out[f"stage{s}"].items()}
        assert p.keys() == j.keys(), (name, s)
        for k in p:
            assert p[k].shape == j[k].shape, (name, s, k)
        np.testing.assert_allclose(p["attn_weight"], j["attn_weight"], atol=1e-4,
                                   err_msg=f"{name} stage{s} attn_weight")
        np.testing.assert_allclose(p["mono_feat"], j["mono_feat"], atol=1e-4,
                                   err_msg=f"{name} stage{s} mono_feat")
        conf = p["photometric_confidence"]
        bound = SCORE_ATOL * (1 + jcfg.ndepths[s - 1] * np.abs(conf)) / np.abs(score_sums[s - 1])
        excess = np.abs(conf - j["photometric_confidence"]) / bound
        assert excess.max() <= 1.0, (name, s, excess.max())
        same = np.isclose(p["depth"], j["depth"], rtol=1e-5, atol=0)
        assert same.mean() >= 0.99, (name, s, same.mean())


def check_round_trip(name: str) -> None:
    """JAX variables -> the port's ``state_dict`` -> the JAX package's
    reference -> flax transplant gives back every leaf, equal."""
    jcfg = jax_config(name)
    vs = _variables(JaxMVS4Net(jcfg), _SCENE, seed=1)
    back = torch_state_dict_to_flax(port_model(name, vs).state_dict(), vs, jcfg)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_vs = dict(jax.tree_util.tree_leaves_with_path(vs))
    assert flat_back.keys() == flat_vs.keys()
    for k, v in flat_vs.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=f"{name} {k}")


NAMES = [name for name, _ in VARIANTS[:5]]


@pytest.mark.parametrize("name", NAMES)
def test_variant_eval_forward_matches_jax(name):
    check_eval_forward(name)


@pytest.mark.filterwarnings("ignore:pos_enc=2")
@pytest.mark.parametrize("name", NAMES)
def test_variant_state_dict_round_trip(name):
    check_round_trip(name)
