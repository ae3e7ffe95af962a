"""The port's kernels K1 (warp + group correlation) and K2 (FPN top-down
level): their plain PyTorch versions against the JAX package, on the CPU,
and the CUDA kernels against the plain versions on the card (marked
``cuda``, skipped without one).

Inputs are made with numpy from a seed and handed to both frameworks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    relative_projection as jax_relative_projection,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    resize_align_corners as jax_resize,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.pallas.topdown_fused import (
    topdown_fused_chain,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.warp_cor import (
    correlate_view as jax_correlate_view,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.warp_mxu import (
    band_coverage,
    warp_cor_v3_ik,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    topdown as k2,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_cor as k1,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _k1_inputs(B, H, W, D, C, seed, hs=None, ws=None):
    """Plane-scene geometry (view 1 against view 0), random features and a
    per-pixel jittered inverse-depth sweep over the scene's range."""
    rng = np.random.default_rng(seed)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=seed + i) for i in range(B)])
    pr = batch["proj_matrices"]["stage4"]
    rel = np.asarray(jax_relative_projection(jnp.asarray(pr[:, 1]), jnp.asarray(pr[:, 0])))
    hs, ws = hs or H, ws or W
    src = rng.standard_normal((B, hs, ws, C)).astype(np.float32)
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    return src, ref, rel.astype(np.float32), (1.0 / inv).astype(np.float32)


# (C, G) pairs of the four flagship stages, plus a geometry where the
# sweep leaves the source image (smaller source than reference)
K1_CASES = [
    (8, 4, None), (16, 4, None), (32, 8, None), (64, 8, None), (8, 2, (20, 28)),
]


@pytest.mark.parametrize("C,G,src_hw", K1_CASES)
def test_warp_cor_ref_matches_jax_correlate_view(C, G, src_hw):
    """K1's plain version against JAX ``correlate_view(impl="gather")`` in
    float32. Tolerance 2e-5: the coordinates differ by float32 rounding
    (explicit products here, an einsum in JAX), which moves the bilinear
    weights by ~1e-6 on O(1) features."""
    B, H, W, D = 2, 24, 32, 4
    hs, ws = src_hw or (None, None)
    src, ref, rel, hypo = _k1_inputs(B, H, W, D, C, seed=C + G, hs=hs, ws=ws)
    want = jax_correlate_view(
        jnp.asarray(src), jnp.asarray(ref), jnp.asarray(rel), jnp.asarray(hypo),
        group_cor=True, group_dim=G, impl="gather",
    )
    got = k1.warp_cor_ref(_t(src), _t(ref), _t(rel), _t(hypo), G)
    assert got.shape == (B, D, H, W, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_warp_cor_ref_matches_pallas_v3_ik():
    """K1's plain version against the TPU kernel's own entry point
    (``warp_cor_v3_ik``, Pallas interpret mode), transposed from its native
    ``[B, D, T, TR, G, W]``, at the column-chunked shape of
    tests/test_warp_mxu.py (W=256, band 12, xband 144). The banded kernel
    drops taps outside its band, so the geometry must have zero band
    coverage first; atol 1e-3 covers its in-kernel coordinate rounding, as
    that test states."""
    B, H, W, D, C, G, band, xb = 2, 64, 256, 4, 8, 4, 12, 144
    rng = np.random.default_rng(0)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=i) for i in range(B)])
    pr = jnp.asarray(batch["proj_matrices"]["stage4"])
    rel = jax_relative_projection(pr[:, 1], pr[:, 0])
    hypo = np.linspace(425.0, 935.0, D)[None, :, None, None] * np.ones((B, D, H, W))
    hypo = hypo.astype(np.float32)
    src = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    cov = band_coverage(rel, jnp.asarray(hypo), H, band=band, tile_rows=8,
                        src_w=W, xband=xb, tile_cols=128)
    assert float(cov) == 0.0
    native = warp_cor_v3_ik(jnp.asarray(src), jnp.asarray(ref), rel,
                            jnp.asarray(hypo), band, 8, xb, G)
    want = np.asarray(native).transpose(0, 1, 2, 3, 5, 4).reshape(B, D, H, W, G)
    got = k1.warp_cor_ref(_t(src), _t(ref), _t(np.asarray(rel)), _t(hypo), G)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_warp_cor_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper computes the plain version and launches
    nothing: the launch counters stay where they were."""
    src, ref, rel, hypo = _k1_inputs(1, 16, 16, 4, 8, seed=3)
    before = _build.launch_counts()
    got = k1.warp_cor(_t(src), _t(ref), _t(rel), _t(hypo), 4)
    want = k1.warp_cor_ref(_t(src), _t(ref), _t(rel), _t(hypo), 4)
    assert torch.equal(got, want)
    assert _build.launch_counts() == before


def _k2_chain_inputs(seed=9):
    """The shape of tests/test_topdown_fused.py's chain test: L2 half-res
    8x12 doubling to (16,24) -> (32,48) -> (64,96), Ci=64,
    (Cs, Co) = (32,32), (16,16), (8,8)."""
    rng = np.random.default_rng(seed)
    N, Ci, Hh, Wh = 1, 64, 8, 12
    intra = rng.standard_normal((N, Hh, Wh, Ci)).astype(np.float32)
    skips, weights = [], []
    for lvl, (cs, co) in enumerate([(32, 32), (16, 16), (8, 8)]):
        H, W = 2 ** (lvl + 1) * Hh, 2 ** (lvl + 1) * Wh
        skips.append(rng.standard_normal((N, H, W, cs)).astype(np.float32))
        weights.append((
            (rng.standard_normal((1, 1, cs, Ci)) * 0.1).astype(np.float32),
            (rng.standard_normal((Ci,)) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, Ci, co)) * 0.05).astype(np.float32),
        ))
    return intra, skips, weights


def _port_chain(intra, skips, weights, level=k2.topdown_level_ref):
    """The three levels through the port's function, HWIO weights
    transposed to the port's OIHW."""
    outs, us = [], []
    cur = _t(intra)
    for skip, (wi, bi, wo) in zip(skips, weights):
        o, cur = level(
            cur, _t(skip), _t(wi.transpose(3, 2, 0, 1)), _t(bi),
            _t(wo.transpose(3, 2, 0, 1)), with_u=True,
        )
        outs.append(o)
        us.append(cur)
    return outs, us


def _jax_unfused_chain(intra, skips, weights):
    outs, us = [], []
    cur = jnp.asarray(intra)
    for skip, (wi, bi, wo) in zip(skips, weights):
        H, W = skip.shape[1:3]
        cur = jax_resize(cur, (H, W)) + jax.lax.conv_general_dilated(
            jnp.asarray(skip), jnp.asarray(wi), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + jnp.asarray(bi)
        us.append(cur)
        outs.append(jax.lax.conv_general_dilated(
            cur, jnp.asarray(wo), (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ))
    return outs, us


def test_topdown_ref_matches_jax_fused_chain_and_unfused():
    """K2's plain version, chained over the three levels, against the TPU
    kernel's entry point ``topdown_fused_chain`` (Pallas interpret mode) and
    against the unfused XLA chain, outputs and the mid levels' ``u``.
    atol 2e-5 / rtol 1e-5: float32 convolution sum order, the tolerance of
    tests/test_topdown_fused.py's chain test."""
    intra, skips, weights = _k2_chain_inputs()
    got, got_u = _port_chain(intra, skips, weights)
    fused = topdown_fused_chain(
        jnp.asarray(intra), tuple(jnp.asarray(s) for s in skips),
        tuple(tuple(jnp.asarray(w) for w in lw) for lw in weights),
        interpret=True,
    )
    unfused, unfused_u = _jax_unfused_chain(intra, skips, weights)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(fused[i]),
                                   atol=2e-5, rtol=1e-5, err_msg=f"fused o{i + 2}")
        np.testing.assert_allclose(got[i].numpy(), np.asarray(unfused[i]),
                                   atol=2e-5, rtol=1e-5, err_msg=f"unfused o{i + 2}")
        np.testing.assert_allclose(got_u[i].numpy(), np.asarray(unfused_u[i]),
                                   atol=2e-5, rtol=1e-5, err_msg=f"u{i + 2}")


def test_topdown_wrapper_takes_plain_version_on_cpu():
    intra, skips, weights = _k2_chain_inputs(seed=4)
    before = _build.launch_counts()
    got, got_u = _port_chain(intra, skips, weights, level=k2.topdown_level)
    want, want_u = _port_chain(intra, skips, weights)
    for a, b in zip(got + got_u, want + want_u):
        assert torch.equal(a, b)
    assert _build.launch_counts() == before
