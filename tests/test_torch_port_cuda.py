"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the paths through them: the chain backward against autograd of the
plain chain, a small train step and the eval pipeline against the CPU's,
the train CLI's launches, and the rule that a kernel meets autograd only
through its ``autograd.Function``.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there the repository's ``conftest.py``
(which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import test as cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.cli import train as train_cli
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import setup_device
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
    relative_projection,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import (
    band_conv_route,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    attn_fuse as k5,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    band_conv as k6,
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

pytestmark = pytest.mark.cuda


def _k6_per_forward(dtype) -> int:
    """K6's launches per eval forward at the flagship widths (FPN base 8):
    the stem's four 3x3 layers of at most 16 channels and Reg2D.conv0 at four
    stages, and the stem's two 32- and two 64-channel layers where the route
    rule (``models/layers.band_conv_route``) takes them in ``dtype``."""
    return (8 + 2 * band_conv_route(32, 32, dtype) + 2 * band_conv_route(64, 64, dtype))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return setup_device("cuda")


def _close(got, want, tol):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, tol * scale)


# (B, H, W, D) of the depth sweep's launch shapes (csrc/common.cuh:
# sweep_plan): the first case; a ragged row (W 80, as at stage 1, and W 72:
# x tiles that the row does not fill) with H 20 and an odd H 21; one plane
# and 16 planes (planes split between CTAs, or walked by one lane group
# in blocks); B*H above 65535 at a narrow W (rows on grid.x, no plane split)
SWEEP_SHAPES = [(2, 48, 64, 4), (2, 20, 80, 4), (2, 21, 72, 4), (2, 16, 40, 1),
                (2, 16, 40, 16), (1, 70000, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,G,src_hw", [
    (8, 4, None), (16, 4, None), (32, 8, None), (64, 8, None), (8, 2, (20, 28)),
])
@pytest.mark.parametrize("B,H,W,D", SWEEP_SHAPES)
def test_warp_cor_kernel_matches_plain(dev, dtype, C, G, src_hw, B, H, W, D):
    """K1 against ``warp_cor_ref`` on the card (tolerance: ``TOLERANCE``
    of the kernel module), on the four stages' (C, G) and on a source
    smaller than the reference, so that the sweep leaves the image, at each
    of ``SWEEP_SHAPES``."""
    rng = np.random.default_rng(C + G)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=i) for i in range(B)])
    pr = torch.from_numpy(batch["proj_matrices"]["stage4"]).to(dev)
    rel = relative_projection(pr[:, 1], pr[:, 0]).contiguous()
    hs, ws = src_hw or (H, W)
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    hypo = torch.from_numpy((1.0 / inv).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.standard_normal((B, hs, ws, C)).astype(np.float32))
    ref = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    args = (src.to(dev, dtype), ref.to(dev, dtype), rel, hypo, G)
    before = k1.launches
    got = k1.warp_cor(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    _close(got, k1.warp_cor_ref(*args), k1.TOLERANCE[dtype])
    # the same launch into a slot of a larger buffer that starts one element
    # past a 16-byte line: the lane's group means stored one by one
    buf = torch.zeros(got.numel() + 1, dtype=dtype, device=dev)
    slot = buf[1:].view(got.shape)
    k1.warp_cor(*args, out=slot)
    torch.cuda.synchronize()
    assert torch.equal(slot, got) and buf[0].item() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topdown_kernel_matches_plain(dev, dtype):
    """K2 against ``topdown_level_ref`` on the three levels of a chain
    (L2 half-res 8x12 -> 64x96 at L4; (Cs, Co) = (32,32), (16,16), (8,8)),
    both outputs; widths that are not a multiple of the 32-column tile."""
    rng = np.random.default_rng(9)
    cur = torch.from_numpy(rng.standard_normal((2, 8, 12, 64)).astype(np.float32)).to(dev, dtype)
    for lvl, (cs, co) in enumerate([(32, 32), (16, 16), (8, 8)]):
        h, w = 16 << lvl, 24 << lvl
        skip = rng.standard_normal((2, h, w, cs)).astype(np.float32)
        wi = (rng.standard_normal((64, cs, 1, 1)) * 0.1).astype(np.float32)
        bi = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
        wo = (rng.standard_normal((co, 64, 3, 3)) * 0.05).astype(np.float32)
        args = (cur, torch.from_numpy(skip).to(dev, dtype), torch.from_numpy(wi).to(dev),
                torch.from_numpy(bi).to(dev), torch.from_numpy(wo).to(dev))
        before = k2.launches
        o, u = k2.topdown_level(*args, with_u=True)
        o_only = k2.topdown_level(*args)
        torch.cuda.synchronize()
        assert k2.launches == before + 2
        o_ref, u_ref = k2.topdown_level_ref(*args, with_u=True)
        _close(o, o_ref, k2.TOLERANCE[dtype])
        _close(u, u_ref, k2.TOLERANCE[dtype])
        assert torch.equal(o, o_only)
        cur = u_ref


# K2 at sizes that are not multiples of the 8 x 32 tile: (N, Hh, Wh) of the
# half-resolution input, one image smaller than a tile (6 x 10), ragged on
# both axes (26 x 74), and the train path's N = 30
K2_SHAPES = [(1, 3, 5), (1, 13, 37), (30, 12, 20), (2, 5, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hh,Wh", K2_SHAPES)
@pytest.mark.parametrize("cs,co", [(32, 32), (16, 16), (8, 8)])
def test_topdown_kernel_ragged_shapes_match_plain(dev, dtype, N, Hh, Wh, cs, co):
    """K2 against ``topdown_level_ref`` with ``with_u`` (both outputs) and
    ``u_only`` at the three levels' (Cs, Co) on images that are not
    multiples of the tile, including one smaller than a tile and N = 30;
    ``u_only`` gives the ``u`` of ``with_u`` bit for bit, one launch each."""
    rng = np.random.default_rng(N * 1000 + Hh * 10 + Wh + cs)
    H, W = 2 * Hh, 2 * Wh
    intra = torch.from_numpy(rng.standard_normal((N, Hh, Wh, 64)).astype(np.float32))
    skip = torch.from_numpy(rng.standard_normal((N, H, W, cs)).astype(np.float32))
    wi = torch.from_numpy((rng.standard_normal((64, cs, 1, 1)) * cs ** -0.5).astype(np.float32))
    bi = torch.from_numpy((rng.standard_normal((64,)) * 0.1).astype(np.float32))
    wo = torch.from_numpy((rng.standard_normal((co, 64, 3, 3)) / 24).astype(np.float32))
    args = (intra.to(dev, dtype), skip.to(dev, dtype), wi.to(dev), bi.to(dev), wo.to(dev))
    before = k2.launches
    o, u = k2.topdown_level(*args, with_u=True)
    u_only = k2.topdown_level(*args, u_only=True)
    torch.cuda.synchronize()
    assert k2.launches == before + 2
    o_ref, u_ref = k2.topdown_level_ref(*args, with_u=True)
    assert o.shape == (N, H, W, co) and u_only.shape == (N, H, W, 64)
    _close(o, o_ref, k2.TOLERANCE[dtype])
    _close(u, u_ref, k2.TOLERANCE[dtype])
    assert torch.equal(u_only, u)


@pytest.mark.parametrize("cs", [8, 16, 32])
@pytest.mark.parametrize("co", [8, 16, 32])
def test_topdown_kernel_every_channel_pair(dev, cs, co):
    """Every (Cs, Co) instantiation of K2's bf16 tensor-core route against
    ``topdown_level_ref`` (o alone), on a 2 x 18 x 70 image."""
    rng = np.random.default_rng(cs * 100 + co)
    intra = torch.from_numpy(rng.standard_normal((2, 9, 35, 64)).astype(np.float32))
    skip = torch.from_numpy(rng.standard_normal((2, 18, 70, cs)).astype(np.float32))
    wi = torch.from_numpy((rng.standard_normal((64, cs, 1, 1)) * cs ** -0.5).astype(np.float32))
    bi = torch.from_numpy((rng.standard_normal((64,)) * 0.1).astype(np.float32))
    wo = torch.from_numpy((rng.standard_normal((co, 64, 3, 3)) / 24).astype(np.float32))
    args = (intra.to(dev, torch.bfloat16), skip.to(dev, torch.bfloat16), wi.to(dev),
            bi.to(dev), wo.to(dev))
    got = k2.topdown_level(*args)
    torch.cuda.synchronize()
    _close(got, k2.topdown_level_ref(*args), k2.TOLERANCE[torch.bfloat16])


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """No fallback: a CUDA tensor the kernel cannot take raises instead of
    being computed some other way."""
    src = torch.zeros((1, 8, 8, 12), device=dev)
    hypo = torch.ones((1, 2, 8, 8), device=dev)
    rel = torch.eye(4, device=dev)[None]
    with pytest.raises(ValueError, match="not supported"):
        k1.warp_cor(src, src, rel, hypo, 5)                       # G does not divide C
    intra = torch.zeros((1, 4, 4, 64), device=dev)
    skip = torch.zeros((1, 8, 8, 8), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k2.topdown_level(intra, skip, torch.zeros((64, 8, 1, 1), device=dev),
                         torch.zeros(64, device=dev), torch.zeros((8, 64, 3, 3), device=dev))
    with pytest.raises(ValueError, match="not supported"):
        k4.warp_fwd(src.half(), rel, hypo)
    with pytest.raises(ValueError, match="not supported"):
        k5.attn_fuse(torch.zeros((3, 1, 3, 8, 8, 4), device=dev, dtype=torch.float16), 2.0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        k1.warp_cor(torch.zeros((1, 8, 8, 8), device=dev), torch.zeros((1, 8, 8, 8), device=dev),
                    rel, hypo, 4, out=torch.zeros((1, 2, 8, 4, 8), device=dev).transpose(3, 4))
    w6, s6 = torch.zeros((8, 8, 3, 3), device=dev), torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k6.band_conv(torch.zeros((1, 8, 8, 8), device=dev).transpose(1, 2), w6, s6, s6)
    with pytest.raises(ValueError, match="not supported"):
        k6.band_conv(torch.zeros((1, 8, 8, 8), device=dev, dtype=torch.float16), w6, s6, s6)
    with pytest.raises(ValueError, match="shapes"):
        k6.band_conv(torch.zeros((1, 8, 8, 4), device=dev), w6, s6, s6)
    g3 = torch.zeros((1, 2, 8, 8, 12), device=dev)
    with pytest.raises(ValueError, match="shapes"):
        k3.warp_bwd(g3, rel, hypo, (1, 8, 8, 10))                 # C of g and source differ
    with pytest.raises(ValueError, match="not supported"):
        k3.warp_bwd(g3[..., :8].half().contiguous(), rel, hypo, (1, 8, 8, 8))
    with pytest.raises(ValueError, match="aligned"):
        k3.warp_bwd(torch.zeros(1 * 2 * 8 * 8 * 8 + 1, device=dev)[1:].view(1, 2, 8, 8, 8),
                    rel, hypo, (1, 8, 8, 8))
    with pytest.raises(ValueError, match="shapes"):
        k3.warp_bwd(torch.zeros((1, 3, 8, 8, 8), device=dev), rel, hypo, (1, 8, 8, 8))
    with pytest.raises(ValueError, match="shapes"):
        k2.topdown_level(intra, torch.zeros((1, 6, 8, 8), device=dev),
                         torch.zeros((64, 8, 1, 1), device=dev), torch.zeros(64, device=dev),
                         torch.zeros((8, 64, 3, 3), device=dev), u_only=True)
    with pytest.raises(ValueError, match="not supported"):
        k2.topdown_level(intra.half(), torch.zeros((1, 8, 8, 8), device=dev).half(),
                         torch.zeros((64, 8, 1, 1), device=dev), torch.zeros(64, device=dev),
                         torch.zeros((8, 64, 3, 3), device=dev))
    with pytest.raises(ValueError, match="not supported"):                 # Ci = 12
        k2.topdown_level(torch.zeros((1, 4, 4, 12), device=dev),
                         torch.zeros((1, 8, 8, 8), device=dev),
                         torch.zeros((12, 8, 1, 1), device=dev), torch.zeros(12, device=dev),
                         torch.zeros((8, 12, 3, 3), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,src_hw", [(8, None), (16, None), (32, None), (64, None), (8, (20, 28))])
def test_warp_bwd_kernel_matches_plain(dev, dtype, C, src_hw):
    """K3 against ``warp_bwd_ref`` on the card, with g in float32 and bf16
    (tolerance: ``TOLERANCE`` of the kernel module, for the order of its
    atomic float32 sums), on the four stages' widths and on a source
    smaller than the reference, so that the sweep leaves the image."""
    B, H, W, D = 2, 48, 64, 4
    rng = np.random.default_rng(C)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=i) for i in range(B)])
    pr = torch.from_numpy(batch["proj_matrices"]["stage4"]).to(dev)
    rel = relative_projection(pr[:, 1], pr[:, 0]).contiguous()
    hs, ws = src_hw or (H, W)
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    hypo = torch.from_numpy((1.0 / inv).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, D, H, W, C)).astype(np.float32)).to(dev, dtype)
    before = k3.launches
    got = k3.warp_bwd(g, rel, hypo, (B, hs, ws, C))
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, hs, ws, C)
    _close(got, k3.warp_bwd_ref(g, rel, hypo, (B, hs, ws, C)), k3.TOLERANCE[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,src_hw", [(8, None), (16, None), (32, None), (64, None), (8, (20, 28))])
def _k3_case(case, C, dev):
    """Inputs of one K3 footprint case (see the test below)."""
    B = 2
    H, W, D = (64, 80, 8) if case in ("full_range", "scrambled") else (
        48, 64, 8 if case == "narrow" else 4)
    rng = np.random.default_rng(C * 7 + len(case))
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=i) for i in range(B)])
    pr = torch.from_numpy(batch["proj_matrices"]["stage4"]).to(dev)
    rel = relative_projection(pr[:, 1], pr[:, 0]).contiguous()
    if case == "narrow":
        # a window of +-0.5% around a depth map, as stages 2-4 sweep it
        depth = np.linspace(500.0, 800.0, W)[None, None, None, :] * np.ones((B, 1, H, W))
        hypo = depth * (1 + np.linspace(-0.005, 0.005, D)[None, :, None, None])
    else:
        # the full inverse range (stage 1); the small source leaves the image
        inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
        hypo = 1.0 / (inv * (1 + 0.02 * rng.standard_normal((B, D, H, W))))
    if case == "scrambled":
        # every plane holds every depth of the sweep, so even one plane's
        # box overflows the window and is clipped to it
        d = (np.arange(D)[:, None, None] + np.arange(H)[:, None] + np.arange(W)) % D
        hypo = np.take_along_axis(hypo, np.broadcast_to(d, hypo.shape), axis=1)
    hypo = hypo.astype(np.float32)
    if case == "nan_inf":
        hypo[0, 1, 3:9, 5:30] = np.nan
        hypo[1, 2, 10:20, :] = np.inf
        hypo[1, 0, 0:4, 0:4] = -np.inf
        hypo[0, 3, 30:40, 40:60] = 1e30
    hs, ws = (20, 28) if case == "small_source" else (H, W)
    g = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    return g, rel, torch.from_numpy(hypo).to(dev), (B, hs, ws, C)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,C", [
    ("narrow", 8), ("narrow", 64), ("full_range", 64), ("full_range", 8),
    ("scrambled", 64), ("small_source", 16), ("nan_inf", 32), ("nan_inf", 8),
])
def test_warp_bwd_kernel_footprints_match_plain(dev, dtype, case, C):
    """K3's footprint cases against ``warp_bwd_ref`` (tolerance:
    ``TOLERANCE``): a narrow depth window, whose taps over all D fit the
    shared-memory window; the full range at D = 8 (C = 64 overflows the
    window, plane by plane); every depth in every plane (one plane's box
    clipped to the window, the taps outside it straight to device memory);
    a source smaller than the reference; NaN, +-inf
    and huge hypotheses, which give no taps and no fault."""
    g, rel, hypo, shape = _k3_case(case, C, dev)
    g = torch.from_numpy(g).to(dev, dtype)
    before = k3.launches
    got = k3.warp_bwd(g, rel, hypo, shape)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.warp_bwd_ref(g, rel, hypo, shape)
    assert torch.isfinite(got).all()
    _close(got, want, k3.TOLERANCE[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,src_hw", [(8, None), (16, None), (32, None), (64, None), (8, (20, 28))])
@pytest.mark.parametrize("B,H,W,D", SWEEP_SHAPES)
def test_warp_fwd_kernel_matches_plain(dev, dtype, C, src_hw, B, H, W, D):
    """K4 against ``warp_fwd_ref`` on the card, bit for bit (the same
    coordinates, weights and order of the four products; within
    ``TOLERANCE`` of the kernel module a fortiori), on the four stages'
    widths and on a source smaller than the reference, so that the sweep
    leaves the image, at each of ``SWEEP_SHAPES``."""
    rng = np.random.default_rng(C + 1)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=i) for i in range(B)])
    pr = torch.from_numpy(batch["proj_matrices"]["stage4"]).to(dev)
    rel = relative_projection(pr[:, 1], pr[:, 0]).contiguous()
    hs, ws = src_hw or (H, W)
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    hypo = torch.from_numpy((1.0 / inv).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.standard_normal((B, hs, ws, C)).astype(np.float32)).to(dev, dtype)
    before = k4.launches
    got = k4.warp_fwd(src, rel, hypo)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, D, H, W, C)
    want = k4.warp_fwd_ref(src, rel, hypo)
    _close(got, want, k4.TOLERANCE[dtype])
    assert torch.equal(got, want)


# K5's cases (S, D, G, H, W): the flagship stages' (D, G) at three source
# views; other view counts (1-5: the register kernel loads up to 4 views at
# once), depths (D 1, 3, 16, 32: lanes a pixel group 1, 4, 16, 32) and
# groups (G 1, 2, 16, and G 3, 5 cut from the G 4 and 8 instances); H*W 960
# (not a multiple of a CTA's pixels at any D) and odd 943 (one pixel a lane
# where G 4 bf16 or G 2 would take 2 or 4); D 40 and G 20, past the register
# kernel, on the workspace kernel
K5_SHAPES = [(3, 8, 8, 24, 40), (3, 4, 4, 24, 40), (2, 2, 1, 24, 40), (1, 4, 2, 24, 40),
             (3, 16, 8, 24, 40), (2, 3, 4, 24, 40), (1, 32, 2, 24, 40), (2, 4, 16, 24, 40),
             (4, 4, 16, 24, 40), (4, 1, 4, 24, 40), (5, 8, 8, 24, 40), (3, 4, 4, 23, 41),
             (3, 8, 2, 23, 41), (2, 4, 3, 24, 40), (3, 3, 5, 23, 41), (2, 40, 2, 24, 40),
             (1, 4, 20, 24, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,G,H,W", K5_SHAPES)
def test_attn_fuse_kernel_matches_plain(dev, dtype, S, D, G, H, W):
    """K5 against ``attn_fuse_ref`` on the card (tolerance: ``TOLERANCE`` of
    the kernel module) at ``K5_SHAPES``, one launch per call."""
    rng = np.random.default_rng(S * 100 + D * 10 + G + H)
    cors = torch.from_numpy((rng.standard_normal((S, 2, D, H, W, G)) * 0.7)
                            .astype(np.float32)).to(dev, dtype)
    before = k5.launches
    got = k5.attn_fuse(cors, 2.0, 16)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, D, H, W, G)
    _close(got, k5.attn_fuse_ref(cors, 2.0, 16), k5.TOLERANCE[dtype])


@pytest.mark.parametrize("shape,dtype,want", [
    # the eval forward's stages (B4 bf16, D 8/8/4/4, G 8/8/4/4): 16-byte
    # loads take 2 pixels a lane at G 4
    ((4, 8, 64, 80, 8), torch.bfloat16, "register g 8 px 1 lanes 8 ctas 640"),
    ((4, 4, 512, 640, 4), torch.bfloat16, "register g 4 px 2 lanes 4 ctas 10240"),
    # the pipeline's float32 stage 4 (B1): G 4 already fills 16 bytes
    ((1, 4, 512, 640, 4), torch.float32, "register g 4 px 1 lanes 4 ctas 5120"),
    # an odd H*W keeps one pixel a lane; G 3 takes the G 4 instance cut to 3;
    # D 3 rounds up to 4 lanes, D 32 fills the warp
    ((2, 4, 23, 41, 4), torch.bfloat16, "register g 4 px 1 lanes 4 ctas 30"),
    ((2, 3, 24, 40, 3), torch.float32, "register g 4 (G 3) px 1 lanes 4 ctas 30"),
    ((2, 32, 24, 40, 2), torch.bfloat16, "register g 2 px 4 lanes 32 ctas 60"),
    ((2, 4, 24, 40, 16), torch.float32, "register g 16 px 1 lanes 4 ctas 30"),
    # beyond 32 depths or 16 groups: the workspace kernel
    ((2, 40, 24, 40, 2), torch.float32, "workspace"),
    ((2, 4, 24, 40, 20), torch.bfloat16, "workspace"),
])
def test_attn_fuse_plan_names_the_launch_shape(dev, shape, dtype, want):
    """``attn_fuse.plan`` names the kernel and launch shape the library
    chooses for a call: G rounded up to a power of two, the pixels a lane
    (16-byte loads where G fills less and H*W is a multiple), the lanes a
    pixel group (D rounded up to a power of two) and the CTAs of 8 warps;
    the workspace kernel past 32 depths or 16 groups."""
    assert k5.plan(*shape, dtype) == want


@pytest.mark.parametrize("D,G", [(16, 8), (16, 4), (3, 4)])
def test_eval_aggregate_at_any_depth_matches_cpu(dev, D, G):
    """The eval aggregation (K1 into one buffer, then K5) at depths other
    than the flagship's (an ``--ndepths`` of 16, an odd D) on the
    card against the same call on the CPU (plain versions), float32: within
    1e-4 of max(1, max|plain|), K1 and K5 each within 1e-5 of theirs and the
    weights' exponentials carrying K1's differences into the sums."""
    B, H, W, C, V = 2, 24, 40, 16, 3
    rng = np.random.default_rng(D * 10 + G)
    batch = batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)])
    projs = torch.from_numpy(batch["proj_matrices"]["stage4"])
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    hypo = torch.from_numpy((1.0 / inv).astype(np.float32))
    feats = [torch.from_numpy((rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32))
             for _ in range(V)]
    kw = dict(group_cor=True, group_dim=G, attn_temp=2.0)
    before = (k1.launches, k5.launches)
    with torch.inference_mode():
        got = epipolar_aggregate([f.to(dev) for f in feats], projs.to(dev), hypo.to(dev), **kw)
        torch.cuda.synchronize()
    assert (k1.launches - before[0], k5.launches - before[1]) == (V - 1, 1)
    assert got.shape == (B * D, H, W, G)
    _close(got.cpu(), epipolar_aggregate(feats, projs, hypo, **kw), 1e-4)


def test_eval_cli_sets_up_the_card_in_float32(dev):
    """The eval CLI on the card (``cli.test.main`` with its default
    ``--device``) turns TF32 off for cuDNN convolutions and matmuls before
    it builds anything, so that a float32 configuration runs in float32:
    the precision at which ``chip_smoke.py`` and these tests check the
    path. The flags are process-wide and left off, as the fixture sets
    them."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cli.main(["--interval_scale", "1"])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_eval_pipeline_matches_cpu(dev):
    """The eval pipeline (depth maps of 4 views at 64x128, the consistency
    filter, the fused cloud) on the card against the CPU, by
    ``checks.check_pipeline``: depth equal at >= 99% of each view's pixels,
    final masks agreeing at >= 99%, point counts within 1%. The forward is
    captured: the first view's call launches K1 12, K2 3, K5 4 times and K6
    as its float32 route rule gives, once in the warm-up and once in the
    capture, and the other three views replay the graph."""
    before = (k1.launches, k2.launches, k5.launches, k6.launches)
    checks.check_pipeline(dev)
    assert (k1.launches - before[0], k2.launches - before[1], k5.launches - before[2],
            k6.launches - before[3]) == (24, 6, 8, 2 * _k6_per_forward(torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topdown_chain_function_matches_plain_autograd(dev, dtype):
    """The chain ``autograd.Function`` (K2 forward, K2 re-deriving ``u`` in
    the backward) against autograd through ``topdown_level_ref``: outputs
    and the gradients of intra, the skips, wi, bi, wo, within
    ``checks.CHAIN_TOLERANCE`` (L2 half-res 8x12 -> 64x96 at L4, 3 images;
    widths that are not a multiple of the 32-column tile). The Function
    launches K2 six times."""
    leaves, grads = checks.chain_inputs(3, 8, 12, dtype, dev,
                                        torch.Generator(device=dev).manual_seed(10))
    before = k2.launches
    checks.check_chain_backward(leaves, grads)
    torch.cuda.synchronize()
    assert k2.launches == before + 6


def test_small_train_step_matches_cpu(dev):
    """One float32 train step (recipe loss, Adam) on the card against the
    CPU's plain versions, same weights and batch (B=2, V=3, 64x128), by
    ``checks.check_train_step``: the card takes the CPU's next-stage
    hypotheses and its gradients at the cost volumes and mono depths; then
    the loss within 1e-4 relative, a nonzero gradient on every parameter,
    the FPN outputs' and the kernel-fed parameters' gradients each within
    1e-3 of their max, the stem and Reg2D weights within 0.5. K6 (eval
    only) is not launched."""
    before = (k2.launches, k3.launches, k4.launches, k6.launches)
    checks.check_train_step(dev)
    assert k2.launches - before[0] == 6 and k3.launches - before[1] == 8
    assert k4.launches - before[2] == 8 and k6.launches == before[3]


def test_kernel_wrappers_raise_under_autograd(dev):
    """A kernel launched on raw pointers would give an output without
    ``grad_fn`` and stop gradients silently: under autograd each wrapper
    raises on a CUDA tensor that requires grad, and launches under
    ``no_grad``."""
    src = torch.zeros((1, 8, 8, 8), device=dev, requires_grad=True)
    hypo = torch.ones((1, 2, 8, 8), device=dev)
    rel = torch.eye(4, device=dev)[None].contiguous()
    with pytest.raises(RuntimeError, match="autograd"):
        k1.warp_cor(src, src, rel, hypo, 4)
    g = torch.zeros((1, 2, 8, 8, 8), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        k3.warp_bwd(g, rel, hypo, (1, 8, 8, 8))
    intra = torch.zeros((1, 4, 4, 64), device=dev)
    skip = torch.zeros((1, 8, 8, 8), device=dev)
    wi = torch.zeros((64, 8, 1, 1), device=dev, requires_grad=True)
    bi, wo = torch.zeros(64, device=dev), torch.zeros((8, 64, 3, 3), device=dev)
    with pytest.raises(RuntimeError, match="autograd"):
        k2.topdown_level(intra, skip, wi, bi, wo)
    with pytest.raises(RuntimeError, match="autograd"):
        k2.topdown_level(intra, skip, wi, bi, wo, u_only=True)
    with pytest.raises(RuntimeError, match="autograd"):
        k4.warp_fwd(src, rel, hypo)
    cors = torch.zeros((2, 1, 2, 8, 8, 4), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        k5.attn_fuse(cors, 2.0, 8)
    w6 = torch.zeros((8, 8, 3, 3), device=dev, requires_grad=True)
    s6 = torch.ones(8, device=dev)
    with pytest.raises(RuntimeError, match="autograd"):
        k6.band_conv(src, w6, s6, s6)
    with torch.no_grad():
        k1.warp_cor(src, src, rel, hypo, 4)
        k3.warp_bwd(g, rel, hypo, (1, 8, 8, 8))
        k2.topdown_level(intra, skip, wi, bi, wo)
        k4.warp_fwd(src, rel, hypo)
        k5.attn_fuse(cors, 2.0, 8)
        k6.band_conv(src, w6, s6, s6)
    torch.cuda.synchronize()


# K6 (N, H, W, Ci, Co) at the flagship eval forward's shapes (B4 V4
# 512x640: the FPN stem's conv0.0, conv0.1, conv1.1/conv1.2, Reg2D.conv0 at
# stages 1-4) with N cut to 2, then at odd sizes: 37x97 (tiles cut on both
# axes: W not a multiple of the float32 route's 4-column strip or 64-column
# tile, H of its 32, 16, 8 or 4 tile rows), Ci 3, 5 and 20 (units of 4 or 8
# input channels cut), Co 7 and 24 (channel groups cut); the stem's 32- and
# 64-channel layers (the bf16 tensor-core route's widest instances, CIP 32
# and 64, NT 4 and 8); Ci and Co over 64 (the direct form in bf16, passes
# of 64 output channels in float32: Co 72); W 3 and 1 (one strip, cut);
# N 1500 of 16x70 (3000 work items: each persistent CTA walks many tiles);
# Reg2D.conv0 stage 1 of one pipeline view and conv2.x at N 4 (few work
# items: the float32 route's shorter tiles)
K6_SHAPES = [(2, 512, 640, 3, 8), (2, 512, 640, 8, 8), (2, 256, 320, 16, 16),
             (2, 64, 80, 8, 8), (2, 128, 160, 8, 8), (2, 256, 320, 4, 8), (2, 512, 640, 4, 8),
             (2, 37, 97, 3, 8), (2, 37, 97, 16, 16), (2, 37, 97, 5, 7), (2, 19, 33, 20, 24),
             (2, 128, 160, 32, 32), (2, 64, 80, 64, 64), (2, 19, 33, 96, 16), (2, 21, 35, 8, 72),
             (2, 37, 97, 20, 24), (2, 45, 130, 3, 72), (2, 9, 3, 5, 7), (3, 5, 1, 3, 8),
             (1500, 16, 70, 5, 7), (8, 64, 80, 8, 8), (4, 128, 160, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,Ci,Co", K6_SHAPES)
def test_band_conv_kernel_matches_plain(dev, dtype, N, H, W, Ci, Co):
    """K6 against ``band_conv_ref`` on the card (tolerance: ``TOLERANCE`` of
    the kernel module) at ``K6_SHAPES``, one launch per call."""
    rng = np.random.default_rng(H + W + Ci * 10 + Co)
    x = torch.from_numpy(rng.standard_normal((N, H, W, Ci)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((Co, Ci, 3, 3)) * (9 * Ci) ** -0.5)
                         .astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.uniform(0.5, 2.0, Co).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(0.0, 0.2, Co).astype(np.float32)).to(dev)
    before = k6.launches
    got = k6.band_conv(x, w, s, b)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    assert got.dtype == dtype and got.shape == (N, H, W, Co)
    _close(got, k6.band_conv_ref(x, w, s, b), k6.TOLERANCE[dtype])


def _f32_tile_rows(N, H, W, Co):
    """The float32 route's tile rows and work items for a shape, as stated
    here independently of the library: CTAs of 4 warps (8 at Co over 32)
    over COG = the fewest groups of 8 output channels (at most 8), a warp 4
    rows of one group (16 / COG tile rows, at least 4), or 2 rows where
    that gives fewer work items (tile, pass) than two a SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cog = next(g for g in (1, 2, 4, 8) if 8 * g >= Co or g == 8)

    def items(r):
        return N * -(-H // r) * -(-W // 64) * -(-Co // (8 * cog))

    rows = max(4, 16 // cog)
    if items(rows) < 2 * sms:
        rows //= 2
    return rows, items(rows)


@pytest.mark.parametrize("shape,copy", [
    # the pipeline's float32 layers at B4: conv0.0 (Ci 3, Co 8), conv1.x
    # (16), conv2.x (32); Co 72 loops over two passes of 64, Ci 20 over 3
    # units; Reg2D.conv0 stage 1 of one pipeline view (few tiles of 32 rows:
    # shorter tiles); odd Ci takes 4-byte cp.async
    ((16, 512, 640, 3, 8), "tma 3d"),
    ((16, 256, 320, 16, 16), "tma 4d"),
    ((16, 128, 160, 32, 32), "tma 4d"),
    ((4, 128, 160, 32, 32), "tma 4d"),
    ((2, 21, 35, 20, 72), "tma 4d"),
    ((8, 64, 80, 8, 8), "tma 4d"),
    ((2, 37, 97, 16, 16), "tma 4d"),
    ((2, 37, 97, 5, 7), "cp.async"),
])
def test_band_conv_plan_names_the_float32_launch_shape(dev, shape, copy):
    """``band_conv.plan`` names the float32 launch the library chooses: the
    fewest 8-channel groups that cover Co (at most 8 a pass), the tile rows
    of ``_f32_tile_rows`` by 64 columns, 4 or 8 input channels a staged
    unit, the work items and units counted from the shape, and the copy
    mode (TMA at Ci % 4 == 0 and at Ci <= 3 with W*Ci % 4 == 0, else
    cp.async)."""
    N, H, W, Ci, Co = shape
    cog = next(g for g in (1, 2, 4, 8) if 8 * g >= Co or g == 8)
    cic = 4 if cog == 1 else 8
    rows, items = _f32_tile_rows(N, H, W, Co)
    assert k6.plan(*shape, torch.float32) == (
        f"float32 cog {cog} tile {rows}x64 ci/unit {cic} items {items} "
        f"units {items * -(-Ci // cic)} copy {copy}")


def test_train_cli_launches_band_conv_in_validation_only(dev, tmp_path):
    """One epoch of the train CLI on the card (``synthetic://64x128/2``, B1,
    V3, the DTU recipe's model in bf16): the steps are captured, so the
    first train step launches K4 and K3 8 times each twice (its warm-up and
    its capture) and K6 never, and the second replays; the first validation
    batch launches K6 twice as its bf16 route rule gives (the FPN stem's 3x3
    stride-1 layers on the route, Reg2D.conv0 at four stages), and the
    second replays; the losses in ``metrics.jsonl`` are finite."""
    before = (k3.launches, k4.launches, k6.launches)
    logdir = str(tmp_path / "run")
    state = train_cli.main([
        "--dataset", "synthetic", "--trainpath", "synthetic://64x128/2", "--batch_size", "1",
        "--train_nviews", "3", "--test_nviews", "3", "--epochs", "1", "--summary_freq", "1",
        "--logdir", logdir, "--dataloader_workers", "0", "--group_cor", "--inverse_depth",
        "--attn_temp", "2", "--mono", "--rt", "--bf16", "--l1ce_lw", "0.003,1", "--wd", "1e-4"])
    torch.cuda.synchronize()
    assert state.step == 2
    assert (k3.launches - before[0], k4.launches - before[1], k6.launches - before[2]) == (
        16, 16, 2 * _k6_per_forward(torch.bfloat16))
    with open(f"{logdir}/metrics.jsonl") as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f)


# ------------------------------------------------------------------------
# The generic instances: every channel and group count that the JAX package
# takes (any --fpn_base_channel, any --group_cor_dim entry dividing its
# stage's C), outside the compile-time sets of the fast instances. FPN base
# 4 carries C = 32/16/8/4, base 16 C = 128/64/32/16 (G up to 16); odd bases
# give C that are not multiples of 4 or 8.


def _sweep(dev, B, H, W, D, C, seed, src_hw=None):
    rng = np.random.default_rng(seed)
    batch = batch_samples([make_plane_scene(V=2, H=H, W=W, seed=i) for i in range(B)])
    pr = torch.from_numpy(batch["proj_matrices"]["stage4"]).to(dev)
    rel = relative_projection(pr[:, 1], pr[:, 0]).contiguous()
    inv = np.linspace(1 / 935.0, 1 / 425.0, D)[None, :, None, None]
    inv = inv * (1 + 0.02 * rng.standard_normal((B, D, H, W)))
    hypo = torch.from_numpy((1.0 / inv).astype(np.float32)).to(dev)
    hs, ws = src_hw or (H, W)
    src = rng.standard_normal((B, hs, ws, C)).astype(np.float32)
    return rng, rel, hypo, torch.from_numpy(src)


# (B, H, W, D) of the generic instances' cases: the first; a ragged row,
# an odd H and 16 planes; B*H above 65535 at a narrow W
GENERIC_SHAPES = [(2, 24, 40, 4), (2, 21, 72, 16), (1, 70000, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,G", [(4, 2), (128, 16), (64, 16), (32, 16), (12, 3), (3, 1), (6, 2)])
@pytest.mark.parametrize("B,H,W,D", GENERIC_SHAPES)
def test_warp_cor_generic_instance_matches_plain(dev, dtype, C, G, B, H, W, D):
    """K1's generic instance (C or G outside {8, 16, 32, 64} x {1, 2, 4, 8})
    against ``warp_cor_ref`` (``TOLERANCE``), one launch each; its loads
    are 8, 4 or 1 channels wide as C allows."""
    assert C not in k1.FAST_CHANNELS or G not in k1.FAST_GROUPS
    rng, rel, hypo, src = _sweep(dev, B, H, W, D, C, C * 10 + G, (20, 28))
    ref = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    args = (src.to(dev, dtype), ref.to(dev, dtype), rel, hypo, G)
    before = k1.launches
    got = k1.warp_cor(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1 and got.shape == (B, D, H, W, G)
    _close(got, k1.warp_cor_ref(*args), k1.TOLERANCE[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [4, 128, 12, 6, 3])
@pytest.mark.parametrize("B,H,W,D", GENERIC_SHAPES)
def test_warp_fwd_generic_instance_matches_plain(dev, dtype, C, B, H, W, D):
    """K4's generic instance (C outside {8, 16, 32, 64}; lanes of 8, 4 or 1
    channels, up to 32 lanes a pixel) against ``warp_fwd_ref``, bit for bit
    as the compile-time instances."""
    assert C not in k4.FAST_CHANNELS
    _, rel, hypo, src = _sweep(dev, B, H, W, D, C, C + 5)
    src = src.to(dev, dtype)
    before = k4.launches
    got = k4.warp_fwd(src, rel, hypo)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and got.shape == (B, D, H, W, C)
    want = k4.warp_fwd_ref(src, rel, hypo)
    _close(got, want, k4.TOLERANCE[dtype])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [4, 128, 12, 6, 3, 1])
def test_warp_bwd_generic_instance_matches_plain(dev, dtype, C):
    """K3 at the widths of other FPN bases: float4 atomics where C % 4 == 0
    (4, 12, 128), scalar atomics otherwise (6, 3, 1), against
    ``warp_bwd_ref`` (``TOLERANCE``)."""
    B, H, W, D = 2, 24, 40, 4
    rng, rel, hypo, _ = _sweep(dev, B, H, W, D, C, C + 7)
    g = torch.from_numpy(rng.standard_normal((B, D, H, W, C)).astype(np.float32)).to(dev, dtype)
    before = k3.launches
    got = k3.warp_bwd(g, rel, hypo, (B, H, W, C))
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    _close(got, k3.warp_bwd_ref(g, rel, hypo, (B, H, W, C)), k3.TOLERANCE[dtype])


# (Ci, Cs, Co): the three levels of FPN base 4 and of base 16, an odd base
# (3), a Co that is not a multiple of 4, and one that takes two passes
K2_GENERIC = [(32, 16, 16), (32, 8, 8), (32, 4, 4), (128, 64, 64), (128, 32, 32),
              (128, 16, 16), (24, 3, 3), (64, 8, 12), (64, 32, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,cs,co", K2_GENERIC)
def test_topdown_generic_instance_matches_plain(dev, dtype, ci, cs, co):
    """K2's generic kernel (every float32 shape; in bf16 every shape off the
    tensor-core route) against ``topdown_level_ref`` (``TOLERANCE``) on a
    ragged 2 x 18 x 42 image: ``with_u`` (both outputs), ``o`` alone equal
    to it, and ``u_only`` equal to its ``u``, one launch each."""
    rng = np.random.default_rng(ci * 100 + cs * 10 + co)
    N, Hh, Wh = 2, 9, 21
    intra = torch.from_numpy(rng.standard_normal((N, Hh, Wh, ci)).astype(np.float32))
    skip = torch.from_numpy(rng.standard_normal((N, 2 * Hh, 2 * Wh, cs)).astype(np.float32))
    wi = torch.from_numpy((rng.standard_normal((ci, cs, 1, 1)) * cs ** -0.5).astype(np.float32))
    bi = torch.from_numpy((rng.standard_normal((ci,)) * 0.1).astype(np.float32))
    wo = torch.from_numpy((rng.standard_normal((co, ci, 3, 3)) * (9 * ci) ** -0.5)
                          .astype(np.float32))
    args = (intra.to(dev, dtype), skip.to(dev, dtype), wi.to(dev), bi.to(dev), wo.to(dev))
    before = k2.launches
    o, u = k2.topdown_level(*args, with_u=True)
    o_only = k2.topdown_level(*args)
    u_only = k2.topdown_level(*args, u_only=True)
    torch.cuda.synchronize()
    assert k2.launches == before + 3
    o_ref, u_ref = k2.topdown_level_ref(*args, with_u=True)
    assert o.shape == (N, 2 * Hh, 2 * Wh, co) and u.shape == (N, 2 * Hh, 2 * Wh, ci)
    _close(o, o_ref, k2.TOLERANCE[dtype])
    _close(u, u_ref, k2.TOLERANCE[dtype])
    assert torch.equal(o, o_only) and torch.equal(u, u_only)


@pytest.mark.parametrize("base,groups", [(4, (8, 8, 4, 2)), (16, (16, 8, 4, 4))])
def test_eval_forward_at_other_fpn_widths_matches_cpu(dev, base, groups):
    """The float32 eval forward at FPN base 4 and 16 (``--fpn_base_channel``,
    ``--group_cor_dim``) on the card against the CPU, by
    ``checks.check_forward``: every stage's attention within 1e-3 and depth
    equal at >= 99% of pixels, through K1 (8 launches: 2 source views at 4
    stages), K2 (3), K5 (4)."""
    before = (k1.launches, k2.launches, k5.launches)
    checks.check_forward(dev, base, groups)
    assert (k1.launches - before[0], k2.launches - before[1], k5.launches - before[2]) == (
        8, 3, 4)


def test_small_train_step_at_fpn_base_4_matches_cpu(dev):
    """One float32 train step at FPN base 4, ``group_cor_dim`` (8, 8, 4, 2),
    on the card against the CPU by ``checks.check_train_step``: K4 and K3
    at C = 32/16/8/4 (the last on K4's generic instance), K2's generic
    kernel at Ci = 32 forward and backward."""
    before = (k2.launches, k3.launches, k4.launches)
    checks.check_train_step(dev, base=4, group_cor_dim=(8, 8, 4, 2))
    assert (k2.launches - before[0], k3.launches - before[1], k4.launches - before[2]) == (
        6, 8, 8)


@pytest.mark.parametrize("variant", [v for _, v in checks.VARIANTS],
                         ids=[name for name, _ in checks.VARIANTS])
def test_model_variant_matches_cpu(dev, variant):
    """Every model variant (``checks.VARIANTS``: the flagship with one
    change) on the card against the CPU, in float32: the eval forward by
    ``checks.check_forward`` (B1 V3 64x128; K1 8 launches, K2 3, K5 4) and
    one train step by ``checks.check_train_step`` (K2 6, K3 8, K4 8, K6
    none), each with its tolerances; in training every parameter, the
    variant's own included, needs a nonzero gradient."""
    before = (k1.launches, k2.launches, k5.launches)
    checks.check_forward(dev, variant=variant)
    assert (k1.launches - before[0], k2.launches - before[1], k5.launches - before[2]) == (
        8, 3, 4)
    before = (k2.launches, k3.launches, k4.launches, k6.launches)
    checks.check_train_step(dev, variant=variant)
    assert (k2.launches - before[0], k3.launches - before[1], k4.launches - before[2]) == (
        6, 8, 8)
    assert k6.launches == before[3]


# ------------------------------------------ the row-sharded eval (--space) --

def _space_models_and_batch(dev, dtype, B=1, V=3, H=256, W=128):
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        batch_to_torch,
    )

    cfg = checks.eval_dtu_config(str(dtype).replace("torch.", ""))
    model = checks.seeded_model(cfg, 5, dev)
    scene = batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)])
    return model, batch_to_torch(scene, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2, 4])
def test_space_windows_match_the_unsharded_forward(dev, dtype, S):
    """The row-sharded forward over ``[card] * S`` (256x128, halo 48: stage
    4 on S windows) against the unsharded forward on the card, every
    stage, at ``checks.compare_space``'s limits (float32: the JAX package's
    agreement limits; bf16: statistical); K1, K5 and K6 launch S times as
    often as in the unsharded forward."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
        sharded_eval_forward,
    )

    model, b = _space_models_and_batch(dev, dtype)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    with torch.inference_mode():
        before = (k1.launches, k5.launches, k6.launches)
        want = model(*args)
        whole = [n - m for n, m in zip((k1.launches, k5.launches, k6.launches), before)]
    before = (k1.launches, k5.launches, k6.launches)
    got = sharded_eval_forward(model, [dev] * S, space=S)(*args)
    torch.cuda.synchronize()
    assert [n - m for n, m in zip((k1.launches, k5.launches, k6.launches), before)] == \
        [S * n for n in whole]
    dv = b["depth_values"]
    checks.compare_space(got, want, dtype, (dv[:, -1] - dv[:, 0]).max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,h,w,C,G,D", [(352, 512, 640, 8, 4, 4), (224, 256, 320, 16, 4, 4),
                                          (160, 256, 320, 16, 4, 4), (160, 256, 480, 32, 8, 8)])
def test_window_shapes_match_plain(dev, dtype, ws, h, w, C, G, D):
    """K1 (a window of ``ws`` reference rows against the stage's whole
    source of ``h`` rows, the reference principal point moved up by the
    window start), K5 and K6 (Reg2D.conv0) at the window heights of the
    row-sharded eval (352, 224, 160: multiples of 8, not of 64) against
    their plain versions, each at its ``TOLERANCE``."""
    gen = torch.Generator(device=dev).manual_seed(ws + C)
    scene = batch_samples([make_plane_scene(V=2, H=h, W=w, seed=1)])
    projs = torch.from_numpy(scene["proj_matrices"]["stage4"]).to(dev)
    start = (h - ws) // 2
    projs[:, 0, 1, 1, 2] -= start
    rel = relative_projection(projs[:, 1], projs[:, 0]).float().contiguous()
    inv = torch.linspace(1 / 935.0, 1 / 425.0, D, device=dev)[None, :, None, None]
    hypo = (1.0 / (inv * (1 + 0.01 * torch.randn((1, D, ws, w), generator=gen,
                                                  device=dev)))).contiguous()
    src = torch.randn((1, h, w, C), generator=gen, device=dev).to(dtype)
    ref = torch.randn((1, ws, w, C), generator=gen, device=dev).to(dtype)
    _close(k1.warp_cor(src, ref, rel, hypo, G), k1.warp_cor_ref(src, ref, rel, hypo, G),
           k1.TOLERANCE[dtype])
    cors = (torch.randn((2, 1, D, ws, w, G), generator=gen, device=dev) * 0.5).to(dtype)
    _close(k5.attn_fuse(cors, 2.0, C), k5.attn_fuse_ref(cors, 2.0, C), k5.TOLERANCE[dtype])
    x = torch.randn((D, ws, w, G), generator=gen, device=dev).to(dtype)
    wt = torch.randn((8, G, 3, 3), generator=gen, device=dev) * (9 * G) ** -0.5
    scale = torch.rand(8, generator=gen, device=dev) + 0.5
    bias = torch.randn(8, generator=gen, device=dev) * 0.2
    _close(k6.band_conv(x, wt, scale, bias), k6.band_conv_ref(x, wt, scale, bias),
           k6.TOLERANCE[dtype])


# --------------------------------------------- data-parallel training --

@pytest.mark.parametrize("dp_impl", ["gspmd", "shard_map"])
def test_world_one_ddp_step_matches_the_bare_step(dev, dp_impl, tmp_path):
    """Two float32 train steps through ``data_parallel`` on an NCCL group of
    one rank (a ``file://`` store) against the bare ``TrainStep`` from the
    same seed (``checks.check_ddp_step``: the first loss and BatchNorm
    statistics to float32 rounding; the first step's gradients, the state
    after the last step and the second loss within a multiple of the bare
    runs' own run-to-run gaps, which K3's float32 atomics make)."""
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        cfg = checks.small_step_model().cfg

        def make_model():
            return MVS4Net(cfg, device=dev, generator=torch.Generator().manual_seed(3))

        out = checks.check_ddp_step(dev, make_model, checks.small_step_batch(dev), 2,
                                    dp_impls=(dp_impl,))
    finally:
        dist.destroy_process_group()
    (run,) = out["impls"]
    assert out["steps"] == 2 and np.isfinite(run["losses"]).all()


def _broken_reduction(kind: str):
    """``parallel.mesh.data_parallel`` with a DDP communication hook that
    breaks the gradients' reduction: ``zero`` them, ``half`` them, scale
    them by ``1.01``, or ``roll`` each bucket by one entry (every
    gradient's entries moved to their neighbour's place)."""
    from unittest import mock

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel import mesh

    def hook(state, bucket):
        buf = bucket.buffer()
        if kind == "roll":
            buf.copy_(buf.roll(1))
        else:
            buf.mul_({"zero": 0.0, "half": 0.5, "1.01": 1.01}[kind])
        fut = torch.futures.Future()
        fut.set_result(buf)
        return fut

    real = mesh.data_parallel

    def data_parallel(step, dp_impl="gspmd", *, device=None):
        real(step, dp_impl, device=device)
        step.dp.runner.register_comm_hook(None, hook)
        return step

    return mock.patch.object(mesh, "data_parallel", data_parallel)


@pytest.mark.parametrize("kind", ["zero", "1.01"])
def test_world_one_ddp_check_fails_on_a_broken_reduction(dev, kind, tmp_path):
    """``checks.check_ddp_step`` on the card raises where DDP's reduction
    zeroes the gradients or scales them by 1.01 (``_broken_reduction``),
    which the bare runs' noise (K3's atomics) does not hide."""
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        cfg = checks.small_step_model().cfg

        def make_model():
            return MVS4Net(cfg, device=dev, generator=torch.Generator().manual_seed(3))

        with _broken_reduction(kind), pytest.raises(AssertionError, match="gradient|grads"):
            checks.check_ddp_step(dev, make_model, checks.small_step_batch(dev), 2,
                                  dp_impls=("gspmd",))
    finally:
        dist.destroy_process_group()


def test_entry_fn_matches_cpu(dev):
    """``graft_entry.eval_fn`` of the flagship config in float32, weights
    and BatchNorm statistics from one seed (``checks.seeded_model``), at B1
    V3 64x128 on the card against the same on the CPU: stage-4 depth equal
    (rtol 1e-5) at ``checks.FORWARD_DEPTH_AGREEMENT`` of the pixels, as
    ``checks.check_forward`` holds it, and the confidence within 1e-3
    relative at 99% of the pixels where the depth agrees; then
    ``entry()``'s own bf16 ``fn`` on its example arguments (B1 V4 256x320)
    through K1 (12 launches), K2 (3), K5 (4) and K6, each counted twice in
    its first call, which captures (the warm-up's and the capture's
    launches), its depth finite."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    outs = []
    for d in ("cpu", dev):
        model = checks.seeded_model(graft_entry.dtu_model_config("float32"), 1, d)
        b = graft_entry.example_batch(B=1, V=3, H=64, W=128, device=d)
        outs.append([t.float().cpu() for t in graft_entry.eval_fn(model)(
            b["imgs"], b["proj_matrices"], b["depth_values"])])
    (depth_cpu, conf_cpu), (depth, conf) = outs
    same = torch.isclose(depth, depth_cpu, rtol=1e-5, atol=0)
    assert same.float().mean().item() >= checks.FORWARD_DEPTH_AGREEMENT
    close = torch.isclose(conf, conf_cpu, rtol=1e-3, atol=1e-6)[same]
    assert close.float().mean().item() >= 0.99

    fn, args = graft_entry.entry(dev)
    before = (k1.launches, k2.launches, k5.launches, k6.launches)
    depth, _ = fn(*args)
    torch.cuda.synchronize()
    after = (k1.launches, k2.launches, k5.launches, k6.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (
        24, 6, 8, 2 * _k6_per_forward(torch.bfloat16))
    assert depth.shape == (1, 256, 320) and torch.isfinite(depth).all()


def test_bench_runs_on_the_card(dev, capsys):
    """The port's eval bench on the card at B1 V2 64x64, CHAIN 2, ROUNDS 2,
    GROUPS 3: its last line has the JAX bench's keys, a positive rate,
    three groups and the card's name; the line before it the H100 bound,
    ``mfu`` and ``bound_share`` from the card's time."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import bench

    line = bench.main(["--B", "1", "--V", "2", "--H", "64", "--W", "64", "--chain", "2",
                       "--rounds", "2", "--groups", "3"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    assert line["metric"] == bench.METRIC and line["value"] > 0 and line["vs_baseline"] == 1.0
    assert len(line["groups_maps_per_s"]) == 3 and line["spread_maps_per_s"] >= 0
    assert line["device"] and line["device"] != "cpu"
    detail = json.loads(printed[-2])["bench"]
    assert detail["h100_bound_ms"] > 0 and 0 < detail["mfu"] < 1 and 0 < detail["bound_share"] < 1


# ------------------------------------------------------------------------
# Capture and replay (utils/graphs.py, the counterpart of jax.jit): each
# captured entry point replayed against its eager call.

def _small_args(dev):
    """The model inputs of ``checks.small_step_batch`` (B2 V3 64x128)."""
    b = checks.small_step_batch(dev)
    return b["imgs"], b["proj_matrices"], b["depth_values"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_eval_forward_is_bit_equal_to_eager(dev, dtype):
    """The flagship's eval forward (``make_eval_forward``) captured and
    replayed at B2 V3 64x128 (``checks.check_graph_forward``): with cuDNN's
    deterministic algorithms bit-equal to the eager forward in either
    dtype, an earlier call's outputs not overwritten by a later call; as
    the port runs, bit-equal in bf16, and in float32 (whose transposed
    convolutions take a cuDNN algorithm that sums in a run-dependent
    order) agreeing with the eager runs as well as they agree with each
    other."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    model = checks.seeded_model(graft_entry.dtu_model_config(dtype), 1, dev)
    out = checks.check_graph_forward(model, *_small_args(dev))
    assert out["deterministic_cudnn"]["vs_eager"]["bit_equal"] and out["graphs"] == 1
    if dtype == "bfloat16":
        assert out["default"]["vs_eager"]["bit_equal"]


@pytest.mark.parametrize("variant", [v for _, v in checks.VARIANTS],
                         ids=[n for n, _ in checks.VARIANTS])
def test_captured_eval_forward_of_each_variant(dev, variant):
    """Each model variant's eval forward (the flagship with one change,
    float32, B2 V3 64x128) replayed against its eager forward
    (``checks.check_graph_forward``): bit-equal with cuDNN's deterministic
    algorithms; as the port runs, agreeing with the eager runs as well as
    they agree with each other."""
    import dataclasses

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    cfg = dataclasses.replace(graft_entry.dtu_model_config("float32"), **variant)
    checks.check_graph_forward(checks.seeded_model(cfg, 1, dev), *_small_args(dev))


def test_captured_train_step_matches_eager_within_its_noise(dev):
    """Three replayed train steps (the flagship in float32, B2 V3 64x128,
    recipe loss, capturable Adam) against four eager runs from the same
    weights, all with cuDNN's deterministic algorithms: the first loss
    within 1e-6, the first step's gradients (as ``.grad`` holds them after
    the call) and the last BatchNorm statistics within 4x the eager runs'
    own noise (K3's float32 atomics), the later losses likewise
    (``checks.check_graph_train_step``); one graph."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    def make_model():
        return MVS4Net(graft_entry.dtu_model_config("float32"), device=dev,
                       generator=torch.Generator().manual_seed(5))

    out = checks.check_graph_train_step(make_model, checks.small_step_batch(dev), 3)
    assert len(out["losses"]) == 3


def test_captured_eval_step_scalars_equal_eager(dev):
    """The eval step replayed: every scalar bit-equal to the eager step's
    (``checks.check_graph_eval_step``)."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    model = checks.seeded_model(graft_entry.dtu_model_config("bfloat16"), 1, dev)
    assert checks.check_graph_eval_step(model, checks.small_step_batch(dev))["bit_equal"]


def test_capture_of_a_host_read_raises(dev):
    """A function that reads a device value on the host (``.item()``)
    cannot be captured: the call raises ``CaptureError`` naming the
    function and its input signature, keeps no graph, and raises again on
    the next call; nothing falls back to an eager result. (Its one eager
    run is the capture's warm-up, whose result is thrown away.)"""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    runs = []

    def reads_host(x):
        runs.append(1)
        return x * x.sum().item()

    fn = graphs.capture(reads_host, "reads_host")
    x = torch.ones(4, device=dev)
    for _ in range(2):
        with pytest.raises(graphs.CaptureError, match="reads_host.*signature"):
            fn(x)
        assert fn.graphs == {}
    assert len(runs) == 4          # a warm-up and a capture attempt per call
    ok = graphs.capture(lambda x: x * 2, "double")          # the card still captures
    assert torch.equal(ok(x), torch.full((4,), 2.0, device=dev))


def test_a_new_shape_captures_a_second_graph(dev):
    """The eval forward at a second input shape captures a second graph;
    the first shape's replays keep theirs; each replay equals the eager
    forward at its shape."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    model = checks.seeded_model(graft_entry.dtu_model_config("float32"), 1, dev)
    forward = make_eval_forward(model)
    small = graft_entry.example_batch(B=1, V=3, H=64, W=64, device=dev)
    large = graft_entry.example_batch(B=1, V=3, H=64, W=128, device=dev)
    for n, b in ((1, small), (1, small), (2, large), (2, small)):
        args = (b["imgs"], b["proj_matrices"], b["depth_values"])
        got = forward(*args)
        assert len(forward.graphs) == n
        with graphs.eager():
            want = forward(*args)
        assert torch.equal(got["depth"], want["depth"])
