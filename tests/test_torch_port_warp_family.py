"""Every TPU entry point that a port kernel serves, held against its own JAX
wrapper on the CPU, through the kernel's plain PyTorch version:

- K4 (``ops/kernels/warp_fwd.py``, the plain warp forward) against the
  gather reference and the banded Pallas warps ``warp_tiles_pallas_v3``
  without ``ref`` (``homo_warp_mxu(v3=True)``), ``warp_tiles_pallas_xband``
  and ``warp_tiles_pallas`` (``use_pallas=True`` with and without
  ``xband``);
- K5 (``ops/kernels/attn_fuse.py``) against ``attn_fuse_native`` and the
  fused eval ``epipolar_aggregate(impl="mxu_v3", fuse_cor=True)`` at
  ``fuse_attn`` off and on;
- K2's plain version against ``topdown_fused_level(mode="v2")``, K1's
  against ``warp_cor_v3`` (coordinate planes precomputed) and K3's against
  the VJP of ``_warp_v3`` under each mode v1-v4 of
  ``warp_tiles_pallas_xband_bwd``.

Pallas runs in interpret mode, as the JAX package's own tests run it on the
CPU. The banded warps drop taps outside their bands, so each comparison
first asserts ``band_coverage(...) == 0`` on its geometry. Inputs are made
with numpy from a seed, at the smallest shapes the kernels take (W >= 256
for the v3 forward).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    grid_sample_2d as jax_grid_sample,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    relative_projection as jax_relative_projection,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    warp_coords as jax_warp_coords,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.core.geometry import (
    warp_coords_xy as jax_warp_coords_xy,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops import warp_mxu
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.pallas.attn_fuse import (
    attn_fuse_native,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.pallas.topdown_fused import (
    topdown_fused_level,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.warp_cor import (
    epipolar_aggregate as jax_epipolar_aggregate,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    attn_fuse as k5,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    topdown as k2,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_bwd as k3,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_cor as k1,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_fwd as k4,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.warp_cor import (
    epipolar_aggregate,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(B=2, D=4, H=32, W=64, C=8, seed=0, baseline=6.0, tilt=0.02):
    """The geometry of tests/test_warp_mxu.py: a mostly horizontal baseline
    with a slight rotation (tilted epipolar lines) and smooth per-pixel
    hypotheses. numpy ``(src [B,H,W,C], rel [B,4,4], depth [B,D,H,W])``."""
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float32)
    c, s = np.cos(tilt), np.sin(tilt)
    E_src = np.eye(4, dtype=np.float32)
    E_src[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    E_src[0, 3] = baseline
    E_src[1, 3] = 0.3 * baseline

    def stack(E):
        st = np.zeros((2, 4, 4), dtype=np.float32)
        st[0] = E
        st[1, :3, :3] = K
        return np.broadcast_to(st, (B, 2, 4, 4)).copy()

    rel = np.asarray(jax_relative_projection(jnp.asarray(stack(E_src)),
                                             jnp.asarray(stack(np.eye(4, dtype=np.float32)))))
    planes = np.linspace(40.0, 90.0, D, dtype=np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ramp = (0.02 * xx + 0.01 * yy).astype(np.float32)
    depth = np.broadcast_to(planes[None, :, None, None] * (1.0 + ramp)[None, None],
                            (B, D, H, W)).copy()
    src = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return src, rel, depth


def _coverage(rel, depth, H, band, xband=0, W=0, tile_cols=128):
    return float(warp_mxu.band_coverage(
        jnp.asarray(rel), jnp.asarray(depth), H, band=band, tile_rows=8,
        src_w=W, xband=xband, tile_cols=tile_cols))


# --------------------------------------------------------------------- K4 --


@pytest.mark.parametrize("C,baseline", [(8, 6.0), (32, 6.0), (8, 40.0)])
def test_warp_fwd_ref_matches_jax_gather(C, baseline):
    """K4's plain version against JAX ``grid_sample_2d(warp_coords(...))``
    in float32, also where a wide baseline sends many taps out of the image
    (zeros padding). atol 5e-5: the coordinates differ by float32 rounding
    (explicit products here, an einsum in JAX), ~1e-6 px at x ~ 1e2, which
    moves a bilinear sample by that times the step between neighbouring
    N(0, 1) source values (up to ~8)."""
    src, rel, depth = _setup(B=2, H=32, W=64, C=C, baseline=baseline)
    want = jax_grid_sample(jnp.asarray(src), jax_warp_coords(jnp.asarray(rel), jnp.asarray(depth)))
    got = k4.warp_fwd_ref(_t(src), _t(rel), _t(depth))
    assert got.shape == (2, 4, 32, 64, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    if baseline > 10:
        assert (np.abs(np.asarray(want)) < 1e-6).mean() > 0.1   # the sweep leaves the image


# (row of PERF.md's kernel table, homo_warp_mxu arguments, _setup arguments)
K4_ENTRY_POINTS = [
    # xband 160: the 384-column source window exceeds the 256-wide source,
    # so the full-width _kernel runs; xband 96: a 256-column window, so the
    # column-chunked _kernel_xchunk runs
    ("row4_v3", dict(band=16, tile_rows=8, xband=160, tile_cols=64, v3=True),
     dict(B=1, D=2, H=16, W=256)),
    ("row4_v3_xchunk", dict(band=16, tile_rows=8, xband=96, tile_cols=64, v3=True),
     dict(B=1, D=2, H=16, W=256)),
    ("row7_xband", dict(band=16, tile_rows=8, xband=48, tile_cols=32, use_pallas=True),
     dict(B=2, H=32, W=64)),
    ("row8_v1", dict(band=16, tile_rows=8, use_pallas=True), dict(B=2, H=32, W=64)),
]


@pytest.mark.parametrize("name,kw,geo", K4_ENTRY_POINTS, ids=[e[0] for e in K4_ENTRY_POINTS])
def test_warp_fwd_ref_matches_pallas_warps(name, kw, geo):
    """K4's plain version against the banded Pallas forward warps through
    ``homo_warp_mxu``: the v3 flipped-layout kernel without ``ref`` (row 4,
    full-width and column-chunked), the x-banded kernel (row 7) and the v1
    tile kernel (row 8), at geometry whose bands cover every tap. atol 2e-5,
    the JAX package's tolerance for these kernels against its gather."""
    src, rel, depth = _setup(**geo)
    H, W = src.shape[1:3]
    cov = _coverage(rel, depth, H, kw["band"], kw.get("xband", 0), W,
                    kw.get("tile_cols", 128))
    assert cov == 0.0, f"{name}: band coverage {cov}"
    want = warp_mxu.homo_warp_mxu(jnp.asarray(src), jnp.asarray(rel), jnp.asarray(depth), **kw)
    got = k4.warp_fwd_ref(_t(src), _t(rel), _t(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0, err_msg=name)


def test_warp_fwd_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper computes the plain version in float32 and
    launches nothing; a bf16 source gives the float32 result rounded."""
    src, rel, depth = _setup(B=1, H=16, W=32)
    before = _build.launch_counts()
    got = k4.warp_fwd(_t(src), _t(rel), _t(depth))
    assert torch.equal(got, k4.warp_fwd_ref(_t(src), _t(rel), _t(depth)))
    src_bf = _t(src).to(torch.bfloat16)
    got_bf = k4.warp_fwd(src_bf, _t(rel), _t(depth))
    want_bf = k4.warp_fwd_ref(src_bf.float(), _t(rel), _t(depth)).to(torch.bfloat16)
    assert got_bf.dtype == torch.bfloat16 and torch.equal(got_bf, want_bf)
    assert _build.launch_counts() == before


# --------------------------------------------------------------------- K5 --


def test_attn_fuse_ref_matches_pallas_native():
    """K5's plain version against ``attn_fuse_native`` (interpret mode) on
    three source views in the kernel-native ``[B, D, T, TR, G, W]`` layout,
    converted to the port's ``[S, B, D, H, W, G]``. atol 1e-6: the same
    float32 chain (``exp(x - max)`` and a matmul group sum there)."""
    rng = np.random.default_rng(5)
    B, D, T, TR, G, W, C = 1, 4, 2, 8, 4, 128, 16
    natives = [(rng.standard_normal((B, D, T, TR, G, W)) * 0.7).astype(np.float32)
               for _ in range(3)]
    want = attn_fuse_native([jnp.asarray(n) for n in natives], attn_temp=2.0, channels=C,
                            interpret=True)
    want = np.asarray(want).transpose(0, 1, 2, 3, 5, 4).reshape(B, D, T * TR, W, G)
    cors = np.stack([n.transpose(0, 1, 2, 3, 5, 4).reshape(B, D, T * TR, W, G) for n in natives])
    got = k5.attn_fuse_ref(_t(cors), 2.0, C)
    assert got.shape == (B, D, T * TR, W, G)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_attn_fuse_ref_matches_pallas_native_at_16_depths():
    """As above at D=16, G=8 (an ``--ndepths`` of 16, which K5 serves
    through its workspace kernel on the card): K5's plain version against
    ``attn_fuse_native`` (interpret mode), atol 1e-6."""
    rng = np.random.default_rng(6)
    B, D, T, TR, G, W, C = 1, 16, 1, 8, 8, 128, 32
    natives = [(rng.standard_normal((B, D, T, TR, G, W)) * 0.7).astype(np.float32)
               for _ in range(2)]
    want = attn_fuse_native([jnp.asarray(n) for n in natives], attn_temp=2.0, channels=C,
                            interpret=True)
    want = np.asarray(want).transpose(0, 1, 2, 3, 5, 4).reshape(B, D, T * TR, W, G)
    cors = np.stack([n.transpose(0, 1, 2, 3, 5, 4).reshape(B, D, T * TR, W, G) for n in natives])
    got = k5.attn_fuse_ref(_t(cors), 2.0, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _aggregate_inputs(B=1, D=2, H=16, W=256, C=8, V=3, seed=11):
    """The fused-aggregation geometry of tests/test_warp_mxu.py
    (``test_fused_warp_cor_matches_two_step``): features of V views and the
    ``[B, V, 2, 4, 4]`` stacks, ref first."""
    rng = np.random.default_rng(seed)
    _, _, depth = _setup(B=B, D=D, H=H, W=W)
    feats = [rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(V)]
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    stacks = np.zeros((V, 2, 4, 4), np.float32)
    for i in range(V):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = 3.0 * i
        E[1, 3] = 0.9 * i
        stacks[i, 0] = E
        stacks[i, 1, :3, :3] = K
    projs = np.broadcast_to(stacks, (B, V, 2, 4, 4)).copy()
    return feats, projs, depth


@pytest.mark.parametrize("fuse_attn", [False, True])
def test_eval_aggregate_matches_jax_fused_path(fuse_attn):
    """The port's eval aggregation (K1 into one buffer, then K5; plain
    versions here) against JAX ``epipolar_aggregate(impl="mxu_v3",
    fuse_cor=True)`` with the XLA attention chain (``fuse_attn=False``) and
    with ``attn_fuse_native`` (``True``). The JAX test of the kernel only
    compares the two JAX forms; here each is held to an independent
    implementation. atol 1e-3: the fused JAX path computes its coordinates
    in-kernel, which tests/test_warp_mxu.py bounds at 1e-3."""
    feats, projs, depth = _aggregate_inputs()
    kw = dict(group_cor=True, group_dim=4, attn_temp=2.0, attn_fuse_d=True)
    want = jax_epipolar_aggregate(
        [jnp.asarray(f) for f in feats], jnp.asarray(projs), jnp.asarray(depth),
        impl="mxu_v3", fuse_cor=True, fuse_attn=fuse_attn,
        band=16, tile_rows=8, xband=96, tile_cols=64, **kw)
    before = _build.launch_counts()
    got = epipolar_aggregate([_t(f) for f in feats], _t(projs), _t(depth), **kw)
    assert _build.launch_counts() == before      # plain versions on the CPU
    assert got.shape == (2, 16, 256, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_attn_fuse_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper computes the plain version and launches
    nothing; bf16 volumes come back in bf16 from float32 arithmetic."""
    cors = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1, 4, 6, 8, 4))
                            .astype(np.float32))
    before = _build.launch_counts()
    assert torch.equal(k5.attn_fuse(cors, 2.0, 8), k5.attn_fuse_ref(cors, 2.0, 8))
    got = k5.attn_fuse(cors.to(torch.bfloat16), 2.0, 8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, k5.attn_fuse_ref(cors.to(torch.bfloat16), 2.0, 8))
    assert _build.launch_counts() == before


# ----------------------------------------------------------- rows 3, 4, 6 --


def test_topdown_ref_matches_pallas_v2_level():
    """Row 3: K2's plain version against ``topdown_fused_level(mode="v2")``
    (the round-3 all-in-kernel level, interpret mode) at the smallest
    fusable level (Hh >= 6, H = 2 Hh, final = 64). atol 1e-5 / rtol 1e-5,
    tests/test_topdown_fused.py's tolerance for float32 convolution sum
    order."""
    rng = np.random.default_rng(3)
    N, Hh, Wh, Cs, Co = 1, 8, 16, 16, 16
    intra = rng.standard_normal((N, Hh, Wh, 64)).astype(np.float32)
    skip = rng.standard_normal((N, 2 * Hh, 2 * Wh, Cs)).astype(np.float32)
    wi = (rng.standard_normal((1, 1, Cs, 64)) * 0.1).astype(np.float32)
    bi = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((3, 3, 64, Co)) * 0.05).astype(np.float32)
    want = topdown_fused_level(*map(jnp.asarray, (intra, skip, wi, bi, wo)),
                               interpret=True, mode="v2")
    got = k2.topdown_level_ref(_t(intra), _t(skip), _t(wi.transpose(3, 2, 0, 1)), _t(bi),
                               _t(wo.transpose(3, 2, 0, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("xband", [0, 144])
def test_warp_cor_ref_matches_pallas_v3_planes(xband):
    """Row 4 with ``ref``: K1's plain version against ``warp_cor_v3``, the
    fused warp + group correlation from precomputed coordinate planes
    (``kernel_coords=False``), full-width and column-chunked, at a plane
    scene whose band 12 covers every tap. atol 3e-5: the coordinates are
    the same planes on both sides up to the einsum's rounding, as
    tests/test_warp_mxu.py bounds this path."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        batch_samples,
        make_plane_scene,
    )

    B, H, W, D, C, G, band = 1, 16, 256, 2, 8, 4, 12
    rng = np.random.default_rng(4)
    pr = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=0)])["proj_matrices"]["stage4"]
    rel = jax_relative_projection(jnp.asarray(pr[:, 1]), jnp.asarray(pr[:, 0]))
    hypo = (np.linspace(425.0, 935.0, D)[None, :, None, None]
            * np.ones((B, D, H, W))).astype(np.float32)
    src = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    assert _coverage(rel, hypo, H, band, xband, W, 128) == 0.0
    cx, cy = jax_warp_coords_xy(rel, jnp.asarray(hypo))
    want = warp_mxu.warp_cor_v3(jnp.asarray(src), jnp.asarray(ref), cx, cy, band, 8, xband, G)
    got = k1.warp_cor_ref(_t(src), _t(ref), _t(np.asarray(rel)), _t(hypo), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)


@pytest.mark.parametrize("mode", ["v1", "v2", "v3", "v4"])
def test_warp_bwd_ref_matches_pallas_bwd_modes(mode):
    """Row 6: K3's plain version (an explicit scatter-add) against the VJP of
    ``_warp_v3`` (``homo_warp_mxu(v3=True)``), whose backward is
    ``warp_tiles_pallas_xband_bwd`` from coordinate planes, forced to each
    of its modes with the in-kernel-coordinates variant off. atol 1e-3 /
    rtol 1e-4, tests/test_warp_mxu.py's tolerance for these backwards (v3
    and v4 sum in another association order)."""
    src, rel, depth = _setup(B=1, D=2, H=16, W=256)
    kw = dict(band=16, tile_rows=8, xband=96, tile_cols=64, v3=True)
    assert _coverage(rel, depth, 16, 16, 96, 256, 64) == 0.0
    g = np.random.default_rng(6).standard_normal((1, 2, 16, 256, 8)).astype(np.float32)
    warp_mxu.set_bwd_kernel(mode, ik=False)
    try:
        _, vjp = jax.vjp(lambda s: warp_mxu.homo_warp_mxu(s, jnp.asarray(rel),
                                                          jnp.asarray(depth), **kw),
                         jnp.asarray(src))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    finally:
        warp_mxu.set_bwd_kernel("auto", ik=True)
    got = k3.warp_bwd_ref(_t(g), _t(rel), _t(depth), src.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4, err_msg=mode)
