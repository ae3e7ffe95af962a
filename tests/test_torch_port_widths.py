"""Every FPN width and group count the JAX package takes, on the CPU.

Both CLIs take ``--fpn_base_channel`` and ``--group_cor_dim``. With base
``b`` the top-down width is ``8b``, the skips and top-down outputs carry
``4b/2b/b`` channels, and the four stages carry ``8b/4b/2b/b`` channels into
the warps; each ``group_cor_dim`` entry divides its stage's width. The
kernels take these shapes on the card through their generic instances
(``csrc/*.cu``); here, where every wrapper takes its plain version, the
port is held to the JAX package at them:

- the whole float32 eval forward at base 4 with ``(8, 8, 4, 2)`` and at
  base 16 with ``(16, 8, 4, 4)`` (C 4 and 128 at the warps, G 16, Ci 32 and
  128 at the top-down levels), set up as ``tests/test_torch_port_model.py``
  sets it up, with that file's tolerances (and a relative 1e-4 on the
  confidence, see the test);
- the plain versions of K1, K4 and K2 against their JAX XLA counterparts
  at those widths (the JAX Pallas entry points do not take them:
  ``level_fusable`` needs a top-down width of 64).

Inputs are made with numpy from a seed and handed to both frameworks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_kernels import _jax_unfused_chain, _k1_inputs, _port_chain, _t
from test_torch_port_model import _jax_inputs, _variables

from deep_reconstruction_with_epipolar_lines_mvster_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    grid_sample_2d as jax_grid_sample,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    warp_coords as jax_warp_coords,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.warp_cor import (
    correlate_view as jax_correlate_view,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_cor as k1,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_fwd as k4,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)

# two FPN widths beside the flagship's base 8: (--fpn_base_channel, --group_cor_dim)
WIDTHS = [(4, (8, 8, 4, 2)), (16, (16, 8, 4, 4))]


@pytest.mark.parametrize("base,groups", WIDTHS)
def test_eval_forward_at_other_fpn_widths_matches_jax(base, groups):
    """float32, 64x128, 3 views, JAX ``warp_impl="gather"`` with the fused
    top-down and packed convs off, weights carried across; per stage, with
    ``tests/test_torch_port_model.py``'s tolerances: the depth equal (rtol
    1e-5) at >= 99% of pixels, ``attn_weight`` and the mono features within
    1e-4, the confidence within 1e-4 where |Σ_D score| > 0.1, and relative
    1e-4 beside it: max/Σ reaches ~5.6 at base 4, where float32 sums in
    another order differ by ~3e-5 relative (one pixel in 8004)."""
    scene = batch_samples([make_plane_scene(V=3, H=64, W=128, seed=0)])
    jcfg = JaxModelConfig(
        group_cor=True, group_cor_dim=groups, fpn_base_channel=base, inverse_depth=True,
        mono=True, attn_temp=2.0, dtype="float32", remat=False,
        warp_impl="gather", fused_topdown=False, pack_conv=False,
    )
    jnet = JaxMVS4Net(jcfg)
    vs = _variables(jnet, scene)
    jout = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jnet.apply(vs, *_jax_inputs(scene), train=False))
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
    for s in range(1, 5):
        j = jout[f"stage{s}"]
        p = {k: v.float().numpy() for k, v in out[f"stage{s}"].items()}
        assert p["mono_feat"].shape[-1] == base * 8 >> (s - 1), (s, p["mono_feat"].shape)
        np.testing.assert_allclose(p["attn_weight"], j["attn_weight"], atol=1e-4,
                                   err_msg=f"base {base} stage{s} attn_weight")
        np.testing.assert_allclose(p["mono_feat"], j["mono_feat"], atol=1e-4,
                                   err_msg=f"base {base} stage{s} mono_feat")
        well = np.abs(score_sums[s - 1]) > 0.1
        assert well.mean() > 0.9, (s, well.mean())
        np.testing.assert_allclose(
            p["photometric_confidence"][well], j["photometric_confidence"][well],
            atol=1e-4, rtol=1e-4, err_msg=f"base {base} stage{s} confidence")
        same = np.isclose(p["depth"], j["depth"], rtol=1e-5, atol=0)
        assert same.mean() >= 0.99, (base, s, same.mean())


@pytest.mark.parametrize("C,G", [(4, 2), (128, 16), (64, 16), (12, 3)])
def test_warp_cor_ref_matches_jax_at_other_widths(C, G):
    """K1's plain version against JAX ``correlate_view(impl="gather")`` at
    the widths of FPN base 4 and 16 and an odd group size, float32, with
    the tolerance of ``tests/test_torch_port_kernels.py`` (2e-5)."""
    B, H, W, D = 2, 16, 24, 4
    src, ref, rel, hypo = _k1_inputs(B, H, W, D, C, seed=C + G)
    want = jax_correlate_view(
        jnp.asarray(src), jnp.asarray(ref), jnp.asarray(rel), jnp.asarray(hypo),
        group_cor=True, group_dim=G, impl="gather",
    )
    got = k1.warp_cor_ref(_t(src), _t(ref), _t(rel), _t(hypo), G)
    assert got.shape == (B, D, H, W, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("C", [4, 128, 3])
def test_warp_fwd_ref_matches_jax_at_other_widths(C):
    """K4's plain version against JAX ``grid_sample_2d(src, warp_coords)``
    at C 4 and 128 (and 3), float32; 2e-5, the rounding of the coordinates
    (explicit products here, an einsum in JAX) on O(1) features."""
    B, H, W, D = 2, 16, 24, 4
    src, _, rel, hypo = _k1_inputs(B, H, W, D, C, seed=C + 11, hs=12, ws=20)
    want = jax_grid_sample(jnp.asarray(src), jax_warp_coords(jnp.asarray(rel), jnp.asarray(hypo)))
    got = k4.warp_fwd_ref(_t(src), _t(rel), _t(hypo))
    assert got.shape == (B, D, H, W, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("base", [4, 16, 3])
def test_topdown_ref_matches_jax_unfused_at_other_widths(base):
    """K2's plain version, chained over the three levels at top-down width
    Ci = 8 x base (32, 128, 24) and (Cs, Co) = (4b, 4b), (2b, 2b), (b, b),
    against the JAX unfused chain (resize + 1x1 + bias, 3x3), outputs and the
    mid levels' ``u``: atol 2e-5 / rtol 1e-5 as at Ci = 64
    (``tests/test_torch_port_kernels.py``)."""
    rng = np.random.default_rng(base)
    N, Ci, Hh, Wh = 1, 8 * base, 4, 6
    intra = rng.standard_normal((N, Hh, Wh, Ci)).astype(np.float32)
    skips, weights = [], []
    for lvl, c in enumerate((4 * base, 2 * base, base)):
        H, W = Hh << (lvl + 1), Wh << (lvl + 1)
        skips.append(rng.standard_normal((N, H, W, c)).astype(np.float32))
        weights.append((
            (rng.standard_normal((1, 1, c, Ci)) * c ** -0.5).astype(np.float32),
            (rng.standard_normal((Ci,)) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, Ci, c)) * (9 * Ci) ** -0.5).astype(np.float32),
        ))
    got, got_u = _port_chain(intra, skips, weights)
    want, want_u = _jax_unfused_chain(intra, skips, weights)
    for i in range(3):
        assert got[i].shape[-1] == skips[i].shape[-1] and got_u[i].shape[-1] == Ci
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=2e-5, rtol=1e-5,
                                   err_msg=f"base {base} o{i + 2}")
        np.testing.assert_allclose(got_u[i].numpy(), np.asarray(want_u[i]), atol=2e-5,
                                   rtol=1e-5, err_msg=f"base {base} u{i + 2}")
