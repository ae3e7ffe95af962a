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
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    attn_fuse as k5,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    band_conv as k6,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    bn_train as bt,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    convnext_block as cb,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    deform_conv as dc,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    norm_act as na,
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


def _launches(*names):
    """The launches so far of the kernels ``names`` (``_build.launch_counts``):
    a number for one name, a tuple for several."""
    counts = _build.launch_counts()
    return counts[names[0]] if len(names) == 1 else tuple(counts[n] for n in names)


def _launched(before, *names):
    """The launches of ``names`` since ``before = _launches(*names)``."""
    now = _launches(*names)
    return now - before if len(names) == 1 else tuple(n - b for n, b in zip(now, before))


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
    before = _launches("warp_cor")
    got = k1.warp_cor(*args)
    torch.cuda.synchronize()
    assert _launches("warp_cor") == before + 1
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
        before = _launches("topdown")
        o, u = k2.topdown_level(*args, with_u=True)
        o_only = k2.topdown_level(*args)
        torch.cuda.synchronize()
        assert _launches("topdown") == before + 2
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
    before = _launches("topdown")
    o, u = k2.topdown_level(*args, with_u=True)
    u_only = k2.topdown_level(*args, u_only=True)
    torch.cuda.synchronize()
    assert _launches("topdown") == before + 2
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
    s8 = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        na.norm_act(torch.zeros((1, 8, 8, 8), device=dev).transpose(1, 2), s8, s8, s8, s8,
                    1e-5, True)
    with pytest.raises(ValueError, match="not supported"):
        na.norm_act(torch.zeros((1, 8, 8, 8), device=dev, dtype=torch.float16), s8, s8, s8, s8,
                    1e-5, True)
    with pytest.raises(ValueError, match="weight"):
        na.norm_act(torch.zeros((1, 8, 8, 4), device=dev), s8, s8, s8, s8, 1e-5, True)
    with pytest.raises(ValueError, match="float32"):
        na.norm_act(torch.zeros((1, 8, 8, 8), device=dev), s8.bfloat16(), s8, s8, s8, 1e-5, True)
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
    before = _launches("warp_bwd")
    got = k3.warp_bwd(g, rel, hypo, (B, hs, ws, C))
    torch.cuda.synchronize()
    assert _launches("warp_bwd") == before + 1
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
    before = _launches("warp_bwd")
    got = k3.warp_bwd(g, rel, hypo, shape)
    torch.cuda.synchronize()
    assert _launches("warp_bwd") == before + 1
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
    before = _launches("warp_fwd")
    got = k4.warp_fwd(src, rel, hypo)
    torch.cuda.synchronize()
    assert _launches("warp_fwd") == before + 1
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
    before = _launches("attn_fuse")
    got = k5.attn_fuse(cors, 2.0, 16)
    torch.cuda.synchronize()
    assert _launches("attn_fuse") == before + 1
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
    before = _launches("warp_cor", "attn_fuse")
    with torch.inference_mode():
        got = epipolar_aggregate([f.to(dev) for f in feats], projs.to(dev), hypo.to(dev), **kw)
        torch.cuda.synchronize()
    assert _launched(before, "warp_cor", "attn_fuse") == (V - 1, 1)
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
    names = ("warp_cor", "topdown", "attn_fuse", "band_conv")
    before = _launches(*names)
    checks.check_pipeline(dev)
    assert _launched(before, *names) == (24, 6, 8, 2 * _k6_per_forward(torch.float32))


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
    before = _launches("topdown")
    checks.check_chain_backward(leaves, grads)
    torch.cuda.synchronize()
    assert _launches("topdown") == before + 6


def test_small_train_step_matches_cpu(dev):
    """One float32 train step (recipe loss, Adam) on the card against the
    CPU's plain versions, same weights and batch (B=2, V=3, 64x128), by
    ``checks.check_train_step``: the card takes the CPU's next-stage
    hypotheses and its gradients at the cost volumes and mono depths; then
    the loss within 1e-4 relative, a nonzero gradient on every parameter,
    the FPN outputs' and the kernel-fed parameters' gradients each within
    1e-3 of their max, the stem and Reg2D weights within 0.5. K6 (eval
    only) is not launched."""
    names = ("topdown", "warp_bwd", "warp_fwd", "band_conv")
    before = _launches(*names)
    checks.check_train_step(dev)
    assert _launched(before, *names) == (6, 8, 8, 0)


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
    with pytest.raises(RuntimeError, match="autograd"):
        na.norm_act(src, w6[:, 0, 0, 0], s6, s6, s6, 1e-5, True)
    with torch.no_grad():
        k1.warp_cor(src, src, rel, hypo, 4)
        k3.warp_bwd(g, rel, hypo, (1, 8, 8, 8))
        k2.topdown_level(intra, skip, wi, bi, wo)
        k4.warp_fwd(src, rel, hypo)
        k5.attn_fuse(cors, 2.0, 8)
        k6.band_conv(src, w6, s6, s6)
        na.norm_act(src, w6[:, 0, 0, 0].contiguous(), s6, s6, s6, 1e-5, True)
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
    before = _launches("band_conv")
    got = k6.band_conv(x, w, s, b)
    torch.cuda.synchronize()
    assert _launches("band_conv") == before + 1
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
    names = ("warp_bwd", "warp_fwd", "band_conv")
    before = _launches(*names)
    logdir = str(tmp_path / "run")
    state = train_cli.main([
        "--dataset", "synthetic", "--trainpath", "synthetic://64x128/2", "--batch_size", "1",
        "--train_nviews", "3", "--test_nviews", "3", "--epochs", "1", "--summary_freq", "1",
        "--logdir", logdir, "--dataloader_workers", "0", "--group_cor", "--inverse_depth",
        "--attn_temp", "2", "--mono", "--rt", "--bf16", "--l1ce_lw", "0.003,1", "--wd", "1e-4"])
    torch.cuda.synchronize()
    assert state.step == 2
    assert _launched(before, *names) == (16, 16, 2 * _k6_per_forward(torch.bfloat16))
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
    before = _launches("warp_cor")
    got = k1.warp_cor(*args)
    torch.cuda.synchronize()
    assert _launches("warp_cor") == before + 1 and got.shape == (B, D, H, W, G)
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
    before = _launches("warp_fwd")
    got = k4.warp_fwd(src, rel, hypo)
    torch.cuda.synchronize()
    assert _launches("warp_fwd") == before + 1 and got.shape == (B, D, H, W, C)
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
    before = _launches("warp_bwd")
    got = k3.warp_bwd(g, rel, hypo, (B, H, W, C))
    torch.cuda.synchronize()
    assert _launches("warp_bwd") == before + 1
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
    before = _launches("topdown")
    o, u = k2.topdown_level(*args, with_u=True)
    o_only = k2.topdown_level(*args)
    u_only = k2.topdown_level(*args, u_only=True)
    torch.cuda.synchronize()
    assert _launches("topdown") == before + 3
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
    before = _launches("warp_cor", "topdown", "attn_fuse")
    checks.check_forward(dev, base, groups)
    assert _launched(before, "warp_cor", "topdown", "attn_fuse") == (8, 3, 4)


def test_small_train_step_at_fpn_base_4_matches_cpu(dev):
    """One float32 train step at FPN base 4, ``group_cor_dim`` (8, 8, 4, 2),
    on the card against the CPU by ``checks.check_train_step``: K4 and K3
    at C = 32/16/8/4 (the last on K4's generic instance), K2's generic
    kernel at Ci = 32 forward and backward."""
    before = _launches("topdown", "warp_bwd", "warp_fwd")
    checks.check_train_step(dev, base=4, group_cor_dim=(8, 8, 4, 2))
    assert _launched(before, "topdown", "warp_bwd", "warp_fwd") == (6, 8, 8)


@pytest.mark.parametrize("variant", [v for _, v in checks.VARIANTS],
                         ids=[name for name, _ in checks.VARIANTS])
def test_model_variant_matches_cpu(dev, variant):
    """Every model variant (``checks.VARIANTS``: the flagship with one
    change) on the card against the CPU, in float32: the eval forward by
    ``checks.check_forward`` (B1 V3 64x128; K1 8 launches, K2 3, K5 4) and
    one train step by ``checks.check_train_step`` (K2 6, K3 8, K4 8, K6
    none), each with its tolerances; in training every parameter, the
    variant's own included, needs a nonzero gradient."""
    before = _launches("warp_cor", "topdown", "attn_fuse")
    checks.check_forward(dev, variant=variant)
    assert _launched(before, "warp_cor", "topdown", "attn_fuse") == (8, 3, 4)
    names = ("topdown", "warp_bwd", "warp_fwd", "band_conv")
    before = _launches(*names)
    checks.check_train_step(dev, variant=variant)
    assert _launched(before, *names) == (6, 8, 8, 0)


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
    agreement limits; bf16: statistical); K1, K5 and K6 launch 2S times as
    often as in the unsharded forward in the first call, which captures
    (the eager warm-up's S windows and the capture's), and not at all in a
    replay."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
        sharded_eval_forward,
    )

    model, b = _space_models_and_batch(dev, dtype)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    names = ("warp_cor", "attn_fuse", "band_conv")
    with torch.inference_mode():
        before = _launches(*names)
        want = model(*args)
        whole = _launched(before, *names)
    before = _launches(*names)
    forward = sharded_eval_forward(model, [dev] * S, space=S)
    got = forward(*args)
    torch.cuda.synchronize()
    assert _launched(before, *names) == tuple(2 * S * n for n in whole)
    before = _launches(*names)
    forward(*args)
    torch.cuda.synchronize()
    assert _launches(*names) == before
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


@pytest.mark.parametrize("kind", ["zero", "1.01", "roll"])
def test_captured_ddp_check_fails_on_a_broken_reduction(dev, kind, tmp_path):
    """``checks.check_ddp_step`` with the data-parallel step captured (its
    first call warms up, captures and replays; the others replay) raises
    where DDP's reduction zeroes the gradients, scales them by 1.01 or
    rolls each bucket by one entry (``_broken_reduction``): the
    communication hook runs inside the graph."""
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
                                  dp_impls=("gspmd",), captured=True)
    finally:
        dist.destroy_process_group()


def test_captured_ddp_step_matches_eager_and_bare(dev, tmp_path):
    """The data-parallel step captured on an NCCL group of one rank, both
    ``dp_impl`` forms (``gspmd`` with a one-rank group for its BatchNorm
    and loss all-reduces), two float32 steps, with cuDNN's deterministic
    algorithms (``checks.check_graph_ddp_step``): against four eager runs
    of its form and against four bare eager runs by ``check_ddp_step``'s
    rule (first loss and BatchNorm statistics within 1e-6, gradients and
    the last statistics within 4x the runs' noise, the first update
    Adam's on its gradients); one graph a form."""
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        cfg = checks.small_step_model().cfg

        def make_model():
            return MVS4Net(cfg, device=dev, generator=torch.Generator().manual_seed(3))

        out = checks.check_graph_ddp_step(dev, make_model, checks.small_step_batch(dev), 2)
    finally:
        dist.destroy_process_group()
    assert [r["dp_impl"] for r in out["impls"]] == ["gspmd", "shard_map"]


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
    names = ("warp_cor", "topdown", "attn_fuse", "band_conv")
    before = _launches(*names)
    depth, _ = fn(*args)
    torch.cuda.synchronize()
    assert _launched(before, *names) == (24, 6, 8, 2 * _k6_per_forward(torch.bfloat16))
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("space", [1, 2, 4])
def test_captured_sharded_forward_matches_eager(dev, dtype, space):
    """``sharded_eval_forward`` replayed against its eager form
    (``checks.check_graph_space``): ``space`` 1 over ``[card] * 2`` (two
    data shards of a B2 batch), ``space`` 2 and 4 over ``[card] * S`` (row
    windows of stage 4 at 256x128, halo 48, B1): with cuDNN's
    deterministic algorithms bit-equal in either dtype and the first
    call's outputs kept across a later call; as the port runs bit-equal in
    bf16; at ``compare_space``'s limits against the unsharded forward;
    one graph a rank a round (``space`` 1: a round and the join; S: two
    rounds and the join)."""
    model, b = _space_models_and_batch(dev, dtype, B=2 if space == 1 else 1)
    devices = [dev] * (2 if space == 1 else space)
    out = checks.check_graph_space(model, devices, space, b["imgs"], b["proj_matrices"],
                                   b["depth_values"])
    assert out["graphs"] == (3 if space == 1 else 2 * space + 1)


def test_capture_of_a_mesh_path_raises(dev, tmp_path):
    """A host read (``.item()``) in a mesh path fails its capture with
    ``CaptureError`` and keeps no graph, whose eager warm-up ran: the
    sharded forward (a read in a regularizer of its windows) and the
    data-parallel train step (a read in a forward hook)."""
    import torch.distributed as dist

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
        data_parallel,
        sharded_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    model, b = _space_models_and_batch(dev, torch.bfloat16)
    regnet = model._regnet
    model._regnet = lambda s, hypo: (lambda vol: regnet(s, hypo)(vol) * (
        vol.float().mean().item() * 0.0 + 1.0))
    forward = sharded_eval_forward(model, [dev] * 2, space=2)
    with pytest.raises(graphs.CaptureError, match="sharded eval forward"):
        forward(b["imgs"], b["proj_matrices"], b["depth_values"])
    assert forward.graphs == {}

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        train = checks.seeded_model(checks.small_step_model().cfg, 3, dev)
        step = make_train_step(train, checks.RECIPE_LOSS, make_optimizer(train, 1e-4),
                               lambda i: 1e-3)
        data_parallel(step, "shard_map", device=dev)
        train.register_forward_hook(lambda m, i, o: (o["stage4"]["depth"].sum().item(), None)[1])
        with pytest.raises(graphs.CaptureError, match="train step"):
            step(checks.small_step_batch(dev))
        assert step._captured.graphs == {}
    finally:
        dist.destroy_process_group()


def _norm_act_bn(C, gen):
    """An eval BatchNorm's four float32 ``[C]`` tensors (weight, bias,
    mean, var) away from identity, on the CPU."""
    return (torch.rand(C, generator=gen) * 1.5 + 0.5, torch.randn(C, generator=gen) * 0.2,
            torch.randn(C, generator=gen) * 0.2, torch.rand(C, generator=gen) * 1.5 + 0.5)


def _norm_act_folded_cpu(x, weight, bias, mean, var, eps, relu):
    """The kernel's arithmetic on the CPU, each operation rounded once as
    IEEE float32 rounds it: ``scale = weight * (1 / sqrt(var + eps))`` (the
    square root and the reciprocal taken in float64 and rounded once, which
    is the correctly rounded float32 result), ``shift = bias - mean *
    scale``, ``relu(x * scale + shift)`` rounded once to the dtype of x."""
    x, weight, bias, mean, var = (t.cpu() for t in (x, weight, bias, mean, var))
    root = torch.sqrt((var + eps).double()).float()
    scale = weight * (1.0 / root.double()).float()
    shift = bias - mean * scale
    y = x.float() * scale + shift
    return (torch.relu(y) if relu else y).to(x.dtype)


def _forward_norm_act_calls(dev, dtype):
    """``(shape, relu)`` of each ``norm_act`` call of the flagship's eager
    eval forward at B4 V4 512x640 in ``dtype``, in order, and the model."""
    from unittest import mock

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    model = checks.seeded_model(graft_entry.dtu_model_config(dtype), 1, dev)
    batch = graft_entry.example_batch(B=4, V=4, H=512, W=640, device=dev)
    calls, real = [], na.norm_act

    def record(x, *rest):
        calls.append((tuple(x.shape), rest[-1]))
        return real(x, *rest)

    with mock.patch.object(na, "norm_act", record), torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    return calls, model


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norm_act_kernel_matches_plain_at_the_forward_shapes(dev, dtype):
    """``norm_act`` at every shape of its calls in the B4 V4 512x640 eval
    forward (39 calls in bf16, 41 in float32; C 8 to 64), then at C 3 and 72
    and a ragged numel (C not a multiple of the 8 bf16 or 4 float32 values
    a thread moves; n % 8 != 0), at a misaligned x and with and without
    ReLU: bit-equal to its arithmetic rounded on the CPU
    (``_norm_act_folded_cpu``), and within ``norm_act.limit`` of the plain
    version, the eval BatchNorm as the port computed it before."""
    dt = getattr(torch, dtype)
    calls, _ = _forward_norm_act_calls(dev, dtype)
    assert len(calls) == {"bfloat16": 39, "float32": 41}[dtype]
    shapes = sorted(set(calls)) + [((2, 9, 11, 3), True), ((2, 9, 11, 72), False),
                                   ((3, 5, 7, 12), True), ((1, 1, 1, 5), False)]
    gen = torch.Generator().manual_seed(17)
    for shape, relu in shapes:
        C = shape[-1]
        bn = [t.to(dev) for t in _norm_act_bn(C, gen)]
        x = (torch.randn(shape, generator=gen) * 2).to(dev, dt)
        before = _launches("norm_act")
        got = na.norm_act(x, *bn, 1e-5, relu)
        torch.cuda.synchronize()
        assert _launches("norm_act") == before + 1 and got.dtype == dt and got.shape == x.shape
        assert torch.equal(got.cpu(), _norm_act_folded_cpu(x, *bn, 1e-5, relu)), (shape, relu)
        want = na.norm_act_ref(x, *bn, 1e-5, relu)
        gap = (got.float() - want.float()).abs()
        assert (gap <= na.limit(got, want, x, *bn, 1e-5)).all(), (shape, relu)
    # x one element past a 16-byte line: the one-by-one instance
    x = (torch.randn(2 * 5 * 7 * 16 + 1, generator=gen) * 2).to(dev, dt)[1:].view(2, 5, 7, 16)
    bn = [t.to(dev) for t in _norm_act_bn(16, gen)]
    got = na.norm_act(x, *bn, 1e-5, True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _norm_act_folded_cpu(x, *bn, 1e-5, True))


def test_norm_act_reads_live_statistics_under_graph_replay(dev):
    """A captured graph of ``norm_act`` replayed after ``running_var``,
    ``weight``, ``bias`` and ``running_mean`` change in place gives the
    new transform: the kernel folds at every launch, so no fold goes
    stale."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn((8, 32, 40, 16), generator=gen) * 2).to(dev, torch.bfloat16)
    weight, bias, mean, var = (t.to(dev) for t in _norm_act_bn(16, gen))
    na.norm_act(x, weight, bias, mean, var, 1e-5, True)            # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = na.norm_act(x, weight, bias, mean, var, 1e-5, True)
    graph.replay()
    torch.cuda.synchronize()
    first = _norm_act_folded_cpu(x, weight, bias, mean, var, 1e-5, True)
    assert torch.equal(out.cpu(), first)
    with torch.no_grad():
        var.mul_(3.0).add_(0.25)
        weight.neg_()
        bias.add_(0.5)
        mean.sub_(0.1)
    graph.replay()
    torch.cuda.synchronize()
    second = _norm_act_folded_cpu(x, weight, bias, mean, var, 1e-5, True)
    assert not torch.equal(first, second)
    assert torch.equal(out.cpu(), second)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norm_act_launches_once_per_library_route_batchnorm(dev, dtype):
    """One eager eval forward at B4 V4 512x640 launches ``norm_act`` once
    at each eval BatchNorm of ``checks.norm_act_modules`` (every
    library-route block's output is contiguous on the card), counted in
    the recorder's ``norm_act.launches``; a train-mode forward (B1 V3
    128x192, autograd recording) launches it at none."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    dt = getattr(torch, dtype)
    before = _launches("norm_act")
    calls, model = _forward_norm_act_calls(dev, dtype)
    launched = _launched(before, "norm_act")
    want = checks.norm_act_modules(model, dt)
    assert len(calls) == want and launched == want
    model.train()
    assert checks.norm_act_modules(model, dt) == 0
    batch = graft_entry.example_batch(B=1, V=3, H=128, W=192, device=dev)
    before = _launches("norm_act")
    model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    assert _launches("norm_act") == before


def test_eval_batchnorm_takes_the_kernel_at_any_layout_and_refuses_the_rest(dev):
    """An eval ``TorchBatchNorm`` on the card launches ``norm_act`` for a
    transposed input too (made contiguous, the same result as the
    contiguous input's), and raises for a float16 input or one wider than
    ``norm_act.MAX_CHANNELS``: there is no second route on the card."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl

    gen = torch.Generator().manual_seed(23)
    bn = tl.TorchBatchNorm(16).eval().to(dev)
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        _norm_act_bn(16, gen)):
            t.copy_(v)
        x = (torch.randn((2, 9, 11, 16), generator=gen) * 2).to(dev, torch.bfloat16)
        before = _launches("norm_act")
        got = bn(x.transpose(1, 2), relu=True)
        torch.cuda.synchronize()
        assert _launches("norm_act") == before + 1
        assert torch.equal(got, bn(x, relu=True).transpose(1, 2).contiguous())
        with pytest.raises(ValueError, match="not supported"):
            bn(x.half(), relu=True)
        wide = tl.TorchBatchNorm(na.MAX_CHANNELS + 1).eval().to(dev)
        with pytest.raises(ValueError, match="not supported"):
            wide(torch.zeros((1, 2, 2, na.MAX_CHANNELS + 1), device=dev), relu=True)


def test_captured_dcn_forward_matches_the_reference(dev):
    """The benchmark's ``mvster_dcn_bf16`` at its cell's size (B4 V4
    512x640 bf16, ``eval_dcn_bf16``): the captured eval forward of a seeded
    batch against the plain reference with DCN heads
    (``benchmark/reference/mvster_dcn.py``, float32, TF32 off) within the
    cell's limits. The first call launches K1 12, K2 3, K5 4 times, K6 as
    its bf16 route rule gives, ``norm_act`` once a library-route
    BatchNorm (the four heads' included) and ``deform_conv`` once a head
    (the recorder's ``<kernel>.launches``), each
    twice (warm-up and capture), and opens the ``dcn`` span twice a head;
    the replay launches and opens nothing, and gives the same maps."""
    from types import SimpleNamespace

    from benchmark import compare, harness, program
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import trace

    cell = {w["name"]: w for w in harness.load_json(harness.ROOT / "BENCHMARK.json")
            ["workloads"]}["eval_dcn_bf16"]
    config = harness.load_json(harness.find("configs", cell["config"]))
    mix = harness.load_json(harness.find("traffic", cell["traffic"]))
    spec = harness.load_json(harness.find("workloads", cell["name"]))
    driver = harness.load_module(harness.find("drivers", spec["driver"], ".py"))
    ctx = SimpleNamespace(seed=2 ** 31 + 41, device=dev, traffic=mix)
    model, weights = program.build_model(config, ctx.seed, dev)
    batch = program.scenes(ctx, mix["batch"], mix["views"])
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    forward = make_eval_forward(model)
    names = ("warp_cor", "topdown", "attn_fuse", "band_conv", "norm_act", "deform_conv")

    def counts():
        return [*_launches(*names), trace.snapshot()["spans"].get("dcn", {}).get("count", 0)]

    before = counts()
    first = forward(*args)
    torch.cuda.synchronize()
    mid = counts()
    again = forward(*args)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, mid)] == [
        24, 6, 8, 2 * _k6_per_forward(torch.bfloat16),
        2 * checks.norm_act_modules(model, torch.bfloat16), 8, 8]
    assert counts() == mid
    assert all(torch.equal(a, b) for a, b in zip(first["stage_depths"], again["stage_depths"]))
    with driver._dcn_reference():
        ref = compare.reference_depths(weights, config, batch)
    gap = compare.DepthGap(**spec["sure"])
    gap.add(again["stage_depths"], again["confidence"], ref)
    numbers = gap.numbers()
    assert gap.bad_maps == 0
    assert all(numbers[k] <= limit for k, limit in spec["limits"].items()), numbers


def _dcn_inputs(N, H, W, C, kind, gen):
    """A DCN head's inputs on the CPU: x (a ReLU's output, bf16), offsets
    of ``kind`` (bf16) and a weight at fan-in scale (float32). Offsets:
    ``zero``; ``subpixel`` (std 0.3 px); ``4px`` (uniform in +-4 px);
    ``outside`` (whole pixels, half of them moving the tap 1 to 3 image
    sizes away, the rest within +-2 px: integer coordinates on and beyond
    every border); ``nonfinite`` (sub-pixel, a third of them NaN, +inf,
    -inf or +-1e30)."""
    x = torch.randn((N, H, W, C), generator=gen).relu_().to(torch.bfloat16)
    shape = (N, H, W, 18)
    if kind == "zero":
        off = torch.zeros(shape)
    elif kind == "subpixel":
        off = torch.randn(shape, generator=gen) * 0.3
    elif kind == "4px":
        off = torch.rand(shape, generator=gen) * 8 - 4
    elif kind == "outside":
        far = torch.randint(1, 4, shape, generator=gen) * max(H, W)
        sign = torch.randint(0, 2, shape, generator=gen) * 2 - 1
        near = torch.randint(-2, 3, shape, generator=gen)
        off = torch.where(torch.rand(shape, generator=gen) < 0.5, far * sign, near).float()
    else:
        off = torch.randn(shape, generator=gen) * 0.3
        bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30])
        pick = torch.randint(0, len(bad), shape, generator=gen)
        off = torch.where(torch.rand(shape, generator=gen) < 0.33, bad[pick], off)
    weight = torch.randn((C, C, 3, 3), generator=gen) * (9 * C) ** -0.5
    return x, off.to(torch.bfloat16), weight


def _dcn_gap_share(got, x, off, weight):
    """``deform_conv.limit_share`` of a finite bf16 output of x's shape."""
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got).all()
    return dc.limit_share(got, x, off, weight)


@pytest.mark.parametrize("kind", ["zero", "subpixel", "4px", "outside", "nonfinite"])
@pytest.mark.parametrize("N,H,W,C", [(2, 37, 53, 8), (2, 37, 53, 16), (2, 37, 53, 32),
                                     (2, 37, 53, 64), (3, 1, 5, 8), (1, 16, 16, 64)])
def test_deform_conv_kernel_matches_plain(dev, kind, N, H, W, C):
    """``deform_conv`` against its plain version computed in float32 (the
    same bf16 weight) within ``deform_conv.limit`` at every output: C 8,
    16, 32 and 64 at a ragged 37x53 (a last tile cut, tiles across
    images), a 1x5 image and one tile's worth of pixels, at offsets that
    are zero, sub-pixel, +-4 px, whole pixels on and beyond the borders,
    and non-finite; each call one launch, counted."""
    gen = torch.Generator().manual_seed(N * 1000 + C + len(kind))
    x, off, weight = (t.to(dev) for t in _dcn_inputs(N, H, W, C, kind, gen))
    before = _launches("deform_conv")
    got = dc.deform_conv(x, off, weight)
    torch.cuda.synchronize()
    assert _launches("deform_conv") == before + 1
    assert _dcn_gap_share(got, x, off, weight) <= 1.0


def test_deform_conv_kernel_matches_plain_at_each_head_of_the_cell(dev):
    """Each head of ``mvster_dcn_bf16``'s eval forward at its cell's size
    (B4 V4 512x640: C 64, 32, 16, 8 at 1/8 to full resolution), on the
    inputs and offsets the model's forward gives it (seeded weights and
    batch, ``benchmark/program.py``), within ``deform_conv.limit`` of the
    plain version in float32; then at the same shapes with offsets of 4 px
    std (a trained head's pixels, not the fraction of a pixel the seeded
    heads give)."""
    from types import SimpleNamespace
    from unittest import mock

    from benchmark import harness, program
    config = harness.load_json(harness.find("configs", "mvster_dcn_bf16"))
    mix = harness.load_json(harness.find("traffic", "dtu_eval_b4v4"))
    ctx = SimpleNamespace(seed=2 ** 31 + 7, device=dev, traffic=mix)
    model, _ = program.build_model(config, ctx.seed, dev)
    batch = program.scenes(ctx, mix["batch"], mix["views"])
    calls, real = [], dc.deform_conv

    def record(x, off, weight):
        out = real(x, off, weight)
        calls.append((x.clone(), off.clone(), weight.detach().clone(), out.clone()))
        return out

    with mock.patch.object(dc, "deform_conv", record), torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    assert [tuple(c[0].shape) for c in calls] == [
        (16, 512 >> (3 - i), 640 >> (3 - i), 64 >> i) for i in range(4)]
    gen = torch.Generator(device=dev).manual_seed(29)
    for x, off, weight, got in calls:
        assert _dcn_gap_share(got, x, off, weight) <= 1.0, tuple(x.shape)
        wide = (torch.randn(off.shape, generator=gen, device=dev) * 4).to(torch.bfloat16)
        got = dc.deform_conv(x, wide, weight)
        assert _dcn_gap_share(got, x, wide, weight) <= 1.0, tuple(x.shape)


def test_deform_conv_launches_at_each_eval_head_and_none_in_training(dev):
    """One eager eval forward of the DCN model in bf16 launches the kernel
    once a head (the recorder's ``deform_conv.launches``);
    a train-mode forward (autograd recording), an eval forward in float32
    and one at FPN base 4 (a C-4 head takes the plain version, the other
    three the kernel) launch it at no other head."""
    import dataclasses

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    def launched(cfg, train=False, **size):
        model = checks.seeded_model(cfg, 3, dev)
        model.train(train)
        batch = graft_entry.example_batch(device=dev, **size)
        before = _launches("deform_conv")
        with torch.inference_mode(not train):
            model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        torch.cuda.synchronize()
        return _launched(before, "deform_conv")

    size = {"B": 1, "V": 3, "H": 128, "W": 192}
    bf16 = dataclasses.replace(graft_entry.dtu_model_config("bfloat16"), dcn=True)
    assert launched(bf16, **size) == 4
    assert launched(bf16, train=True, **size) == 0
    assert launched(dataclasses.replace(bf16, dtype="float32"), **size) == 0
    assert launched(dataclasses.replace(bf16, fpn_base_channel=4, group_cor_dim=(8, 8, 4, 2)),
                    **size) == 3


def test_deform_conv_reads_the_live_weight_under_graph_replay(dev):
    """A captured graph of ``deform_conv`` replayed after the weight changes
    in place gives the new contraction: the kernel packs the weight at
    every launch, so nothing goes stale."""
    gen = torch.Generator().manual_seed(31)
    x, off, weight = (t.to(dev) for t in _dcn_inputs(2, 24, 40, 16, "4px", gen))
    dc.deform_conv(x, off, weight)                                 # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dc.deform_conv(x, off, weight)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    assert torch.equal(first, dc.deform_conv(x, off, weight))
    with torch.no_grad():
        weight.mul_(-0.5).add_(0.01)
    graph.replay()
    torch.cuda.synchronize()
    second = dc.deform_conv(x, off, weight)
    assert not torch.equal(first, second)
    assert torch.equal(out, second)


def test_deform_conv_refuses_what_it_does_not_take(dev):
    """No fallback on the card: ``deform_conv`` raises on a float32 or
    float16 input, a C outside ``CHANNELS`` (4, 24, 128), a non-contiguous
    or misaligned x, offsets of another shape or dtype, a weight that is
    not float32 or not C x C x 3 x 3, and under autograd."""
    def args(C=8, dtype=torch.bfloat16, H=6, W=7):
        return (torch.zeros((1, H, W, C), device=dev, dtype=dtype),
                torch.zeros((1, H, W, 18), device=dev, dtype=dtype),
                torch.zeros((C, C, 3, 3), device=dev))

    for dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="not supported"):
            dc.deform_conv(*args(dtype=dtype))
    for C in (4, 24, 128):
        with pytest.raises(ValueError, match="not supported"):
            dc.deform_conv(*args(C))
    x, off, w = args(H=7)
    with pytest.raises(ValueError, match="contiguous"):
        dc.deform_conv(x.transpose(1, 2), off, w)
    flat = torch.zeros(7 * 7 * 8 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        dc.deform_conv(flat[1:].view(1, 7, 7, 8), off, w)
    with pytest.raises(ValueError, match="shapes"):
        dc.deform_conv(x, off[..., :16], w)
    with pytest.raises(ValueError, match="not supported"):
        dc.deform_conv(x, off.float(), w)
    with pytest.raises(ValueError, match="float32"):
        dc.deform_conv(x, off, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        dc.deform_conv(x, off, torch.zeros((8, 8, 1, 1), device=dev))
    with pytest.raises(RuntimeError, match="autograd"):
        dc.deform_conv(x, off, w.requires_grad_())


def _bn_train_case(shape, groups, kind, dtype, dev, seed):
    """x, dy and the four float32 ``[C]`` tensors (weight, bias,
    running_mean, running_var) of one ``bn_train`` case, away from
    identity: x ~ 2 N(0, 1) + 0.5, with channel 1 constant (``constant``:
    variance 0) or channel 0 at mean 300 over a spread of 3 (``far_mean``:
    a merge that cancelled would show)."""
    gen = torch.Generator().manual_seed(seed)
    C = shape[-1]
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    if kind == "constant":
        x[..., 1] = 0.75
    elif kind == "far_mean":
        x[..., 0] = 300 + 3 * torch.randn(shape[:-1], generator=gen)
    dy = torch.randn(shape, generator=gen)
    params = (torch.rand(C, generator=gen) * 1.5 + 0.5, torch.randn(C, generator=gen) * 0.2,
              torch.randn(C, generator=gen) * 0.2, torch.rand(C, generator=gen) * 1.5 + 0.5)
    dt = getattr(torch, dtype)
    return (x.to(dev, dt), dy.to(dev, dt), *(t.to(dev) for t in params))


# (N, H, W, C), view groups, kind: G 1 and 5; C 8, 16, 32, 64 (the
# flagship's), 12 (bf16 one value a thread, float32's 4-wide vectors), 3
# (one value a thread in both), 300 (more than 256 lanes a pixel: two
# passes) and 2056 (257 bf16 vectors: two passes); a ragged 37x53; a
# constant channel and a channel far above its spread; no ReLU
BN_TRAIN_CASES = [
    ((5, 16, 20, 8), 5, "plain"), ((4, 16, 20, 16), 1, "plain"), ((10, 8, 12, 32), 5, "plain"),
    ((2, 8, 8, 64), 1, "plain"), ((5, 37, 53, 12), 5, "plain"), ((2, 37, 53, 3), 1, "plain"),
    ((2, 5, 7, 300), 1, "plain"), ((1, 3, 5, 2056), 1, "plain"),
    ((10, 37, 53, 16), 5, "constant"), ((4, 37, 53, 8), 1, "far_mean"),
    ((5, 37, 53, 8), 5, "no_relu"), ((3, 16, 24, 32), 1, "no_relu"),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,groups,kind", BN_TRAIN_CASES)
def test_bn_train_kernel_matches_plain(dev, dtype, shape, groups, kind):
    """The train-mode BatchNorm kernels, one call forward and backward,
    against ``bn_train_ref`` computed in float32 on the CPU from the same x
    (``checks.check_bn_train``): the output, ``running_mean``,
    ``running_var``, dx, dweight and dbias each within its limit
    (``bn_train.limit``, ``grad_limits``, ``running_limit``: a bf16 ulp of
    each output plus float32 ulps of its terms and, for the sums, of the
    sums of their terms' magnitudes), ``num_batches_tracked`` moved by G;
    six launches."""
    args = _bn_train_case(shape, groups, kind, dtype, dev, seed=len(shape) + shape[-1])
    before = _launches("bn_train")
    shares = checks.check_bn_train(*args, groups, kind != "no_relu", ref_device="cpu")
    assert _launched(before, "bn_train") == bt.LAUNCHES_PER_CALL
    assert shares["max_share"] <= 1.0, shares


def _bn_train_calls(dev, dtype, B=1, V=5, H=128, W=192):
    """``{(shape, groups, relu): calls}`` of ``bn_train`` in one train-mode
    forward of the flagship in ``dtype`` at B V HxW (B1 V5 128x192: the
    train step's shapes at a reduced resolution), and the model."""
    from collections import Counter
    from unittest import mock

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry

    model = checks.seeded_model(graft_entry.dtu_model_config(dtype), 1, dev).train()
    batch = graft_entry.example_batch(B=B, V=V, H=H, W=W, device=dev)
    calls, real = Counter(), bt.bn_train

    def record(x, *rest):
        calls[(tuple(x.shape), rest[5], rest[-1])] += 1
        return real(x, *rest)

    with mock.patch.object(bt, "bn_train", record), torch.no_grad():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    return calls, model


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bn_train_kernel_matches_plain_at_the_train_step_shapes(dev, dtype):
    """Each of the flagship's 54 train-mode BatchNorm calls (B1 V5 128x192:
    the FPN's 11 with G 5, Reg2D's and the mono decoder's 43 with G 1; C 8
    to 64, all with ReLU) read from a train-mode forward, one call of each
    shape against the plain version as ``test_bn_train_kernel_matches_plain``
    holds it."""
    calls, model = _bn_train_calls(dev, dtype)
    assert sum(calls.values()) == checks.bn_train_modules(model) == 54
    assert sum(n for (_, g, _), n in calls.items() if g == 5) == 11
    for i, (shape, groups, relu) in enumerate(sorted(calls)):
        args = _bn_train_case(shape, groups, "plain", dtype, dev, seed=100 + i)
        shares = checks.check_bn_train(*args, groups, relu, ref_device="cpu")
        assert shares["max_share"] <= 1.0, (shape, groups, shares)


def test_bn_train_launches_six_at_each_train_batchnorm_and_none_in_eval(dev):
    """An eager float32 train step of the flagship (B2 V3 64x128, recipe
    loss, Adam) launches ``bn_train`` ``LAUNCHES_PER_CALL`` times at each of
    its 54 train-mode BatchNorms (three forward, three backward), counted
    in ``bn_train.launches``; an eval forward launches it at none."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    model = checks.small_step_model().to(dev)
    batch = checks.small_step_batch(dev)
    step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    before = _launches("bn_train")
    with graphs.eager():
        step(batch)
    torch.cuda.synchronize()
    assert _launched(before, "bn_train") == bt.LAUNCHES_PER_CALL * 54
    assert checks.bn_train_modules(model) == 54
    model.eval()
    before = _launches("bn_train")
    with torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    assert _launches("bn_train") == before and checks.bn_train_modules(model) == 0


def test_bn_train_captured_call_reads_live_parameters_and_replays_bit_equal(dev):
    """A captured forward and backward of ``bn_train`` (bf16, G 2, ReLU):
    two replays from the same running statistics give bit-equal outputs,
    gradients and running statistics (no atomics: the sums' order is
    fixed), equal to an eager call's; after ``weight``, ``bias`` and the
    running statistics change in place, a replay gives the eager call's
    result on the new values, not the old one's."""
    x, dy, w, b, rm, rv = _bn_train_case((8, 32, 40, 16), 2, "plain", "bfloat16", dev, seed=9)
    x.requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    nb = torch.zeros((), dtype=torch.long, device=dev)

    def call():
        y = bt.bn_train(x, w, b, rm, rv, nb, 2, 1e-5, 0.9, True)
        return (y, *torch.autograd.grad(y, (x, w, b), dy))

    def run(fn, mean, var):
        with torch.no_grad():
            rm.copy_(mean)
            rv.copy_(var)
        out = [t.clone() for t in fn()]
        torch.cuda.synchronize()
        return out + [rm.clone(), rv.clone()]

    rm0, rv0 = rm.clone(), rv.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                                                   # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches("bn_train")
    with torch.cuda.graph(graph):
        static = call()
    assert _launched(before, "bn_train") == bt.LAUNCHES_PER_CALL

    def replay():
        graph.replay()
        return static

    first, second = run(replay, rm0, rv0), run(replay, rm0, rv0)
    eager = run(call, rm0, rv0)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert all(torch.equal(a, c) for a, c in zip(first, eager))
    with torch.no_grad():
        w.mul_(-1.5)
        b.add_(0.25)
    moved = run(replay, rm0 + 0.1, rv0 * 2)
    eager = run(call, rm0 + 0.1, rv0 * 2)
    assert all(torch.equal(a, c) for a, c in zip(moved, eager))
    assert not torch.equal(moved[0], first[0]) and not torch.equal(moved[-1], first[-1])


def test_bn_train_refuses_what_it_does_not_take(dev):
    """No fallback on the card: ``bn_train`` raises on a float16 input, a
    non-contiguous one, more than ``MAX_CHANNELS`` channels, a batch that
    the view groups do not divide, and parameters that are not float32
    ``[C]``; ``TorchBatchNorm`` in training routes a float16 input to the
    plain chain and launches nothing for it."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl

    def args(C=8, N=4, dtype=torch.bfloat16, w_dtype=torch.float32):
        return (torch.zeros((N, 3, 5, C), device=dev, dtype=dtype),
                torch.ones(C, device=dev, dtype=w_dtype), torch.zeros(C, device=dev),
                torch.zeros(C, device=dev), torch.ones(C, device=dev),
                torch.zeros((), dtype=torch.long, device=dev))

    with pytest.raises(ValueError, match="not supported"):
        bt.bn_train(*args(dtype=torch.float16), 1, 1e-5, 0.9, True)
    x, *rest = args()
    with pytest.raises(ValueError, match="contiguous"):
        bt.bn_train(x.transpose(1, 2), *rest, 1, 1e-5, 0.9, True)
    with pytest.raises(ValueError, match="not supported"):
        bt.bn_train(*args(C=bt.MAX_CHANNELS + 1), 1, 1e-5, 0.9, True)
    with pytest.raises(ValueError, match="divisible"):
        bt.bn_train(*args(N=4), 3, 1e-5, 0.9, True)
    with pytest.raises(ValueError, match="float32"):
        bt.bn_train(*args(w_dtype=torch.bfloat16), 1, 1e-5, 0.9, True)
    bn = tl.TorchBatchNorm(8).to(dev).train()
    before = _launches("bn_train")
    half = bn(torch.randn((4, 3, 5, 8), device=dev, dtype=torch.float16), relu=True)
    torch.cuda.synchronize()
    assert half.dtype == torch.float16 and _launches("bn_train") == before
    bn(torch.randn((4, 3, 5, 8), device=dev, dtype=torch.bfloat16), relu=True)
    torch.cuda.synchronize()
    assert _launched(before, "bn_train") == 3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_captured_convnext4_forward_matches_the_reference(dev, dtype, monkeypatch):
    """The benchmark's ``mvster_convnext4_bf16`` (``eval_convnext4_bf16``), in
    bf16 and in float32, at B1 V4 128x192: the captured eval forward of a
    seeded batch against the plain reference with the patchify ConvNeXt
    pyramid (``benchmark/reference/mvster_convnext.py``, float32, TF32 off)
    within the cell's limits in bf16 and ``eval_dtu_f32``'s in float32.
    The first call launches K1 12, K2 3, K5 4 and K6 6 times (``conv0.0``,
    ``conv0.1`` and the four Reg2D ``conv0``: the pyramid has no FPN4
    ``conv1``-``conv3`` layers), ``norm_act`` once a library-route
    BatchNorm and ``convnext_block`` once a block in bf16 (none in
    float32), each twice (warm-up and capture), and opens the
    ``convnext`` span twice a block; the replay launches and opens
    nothing, and gives the same maps (in float32 under
    ``cudnn.deterministic``, as ``checks.check_graph_forward`` holds it)."""
    from types import SimpleNamespace

    from benchmark import compare, harness, program
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
        make_eval_forward,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import trace

    if dtype == "float32":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cell = {w["name"]: w for w in harness.load_json(harness.ROOT / "BENCHMARK.json")
            ["workloads"]}["eval_convnext4_bf16"]
    config = {**harness.load_json(harness.find("configs", cell["config"])), "dtype": dtype}
    mix = {**harness.load_json(harness.find("traffic", cell["traffic"])),
           "batch": 1, "views": 4, "height": 128, "width": 192}
    spec = harness.load_json(harness.find(
        "workloads", cell["name"] if dtype == "bfloat16" else "eval_dtu_f32"))
    driver = harness.load_module(harness.find("drivers", "eval_convnext", ".py"))
    ctx = SimpleNamespace(seed=2 ** 31 + 43, device=dev, traffic=mix)
    model, weights = program.build_model(config, ctx.seed, dev)
    batch = program.scenes(ctx, mix["batch"], mix["views"])
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    forward = make_eval_forward(model)
    names = ("warp_cor", "topdown", "attn_fuse", "band_conv", "norm_act", "convnext_block")
    tdt = getattr(torch, dtype)

    def counts():
        return [*_launches(*names),
                trace.snapshot()["spans"].get("convnext", {}).get("count", 0)]

    before = counts()
    first = forward(*args)
    torch.cuda.synchronize()
    mid = counts()
    again = forward(*args)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, mid)] == [
        24, 6, 8, 12, 2 * checks.norm_act_modules(model, tdt),
        6 if dtype == "bfloat16" else 0, 6]
    assert counts() == mid
    assert all(torch.equal(a, b) for a, b in zip(first["stage_depths"], again["stage_depths"]))
    with driver._convnext_reference():
        ref = compare.reference_depths(weights, config, batch)
    gap = compare.DepthGap(**spec["sure"])
    gap.add(again["stage_depths"], again["confidence"], ref)
    numbers = gap.numbers()
    assert gap.bad_maps == 0
    assert all(numbers[k] <= limit for k, limit in spec["limits"].items()), numbers


def _cnx_case(dim, seed, N, H, W, dev):
    """A ``ConvNeXt4Block`` in eval on the card with the benchmark's seeded
    weights (``harness.make_weights``: ``gamma`` and the LayerNorm weight
    N(0, 1), as ``eval_convnext4_bf16`` draws them), its parameters in the
    order of ``convnext_block.PARAMS``, and a ReLU'd bf16 input."""
    from benchmark import harness
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.fpn import (
        ConvNeXt4Block,
    )

    block = ConvNeXt4Block(dim).eval().to(dev)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in block.state_dict().items()}
    block.load_state_dict(harness.make_weights(shapes, seed, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, H, W, dim), generator=gen, device=dev).relu_().to(torch.bfloat16)
    return block, tuple(block.get_parameter(n) for n in cb.PARAMS), x


def _cnx_gap_share(got, x, params):
    """``convnext_block.limit_share`` of a finite bf16 block output."""
    N, H, W, dim = x.shape
    assert got.dtype == torch.bfloat16 and got.shape == (N, H // 2, W // 2, 2 * dim)
    assert torch.isfinite(got).all()
    return cb.limit_share(got, x, params)


@pytest.mark.parametrize("N,H,W,dim", [(2, 37, 53, 8), (1, 9, 7, 16), (3, 20, 70, 32),
                                       (2, 33, 35, 32), (1, 35, 66, 16), (1, 2, 2, 8)])
def test_convnext_block_kernel_matches_plain(dev, N, H, W, dim):
    """``convnext_block`` against its plain version computed in float32 (the
    weights rounded as the plain route rounds them) within
    ``convnext_block.limit`` at every output, at dim 8, 16 and 32, on
    shapes whose H/2 and W/2 are no multiple of a tile (16 x 16, 8 x 16 at
    dim 32), an odd H or W (the last row or column unread) and a single
    output pixel; each call one launch, counted."""
    _, params, x = _cnx_case(dim, N * 1000 + H + dim, N, H, W, dev)
    before = _launches("convnext_block")
    with torch.inference_mode():
        got = cb.convnext_block(x, *params)
        torch.cuda.synchronize()
        assert _launches("convnext_block") == before + 1
        assert _cnx_gap_share(got, x, params) <= 1.0


def test_convnext_block_kernel_matches_plain_at_each_block_of_the_cell(dev):
    """Each block of ``mvster_convnext4_bf16``'s eval forward at its cell's
    size (B4 V4 512x640: dim 8, 16, 32 at 1/1, 1/2 and 1/4 resolution), on
    the inputs the model's forward gives it (seeded weights and batch,
    ``benchmark/program.py``), within ``convnext_block.limit`` of the plain
    version in float32."""
    from types import SimpleNamespace
    from unittest import mock

    from benchmark import harness, program
    config = harness.load_json(harness.find("configs", "mvster_convnext4_bf16"))
    mix = harness.load_json(harness.find("traffic", "dtu_eval_b4v4"))
    ctx = SimpleNamespace(seed=2 ** 31 + 9, device=dev, traffic=mix)
    model, _ = program.build_model(config, ctx.seed, dev)
    batch = program.scenes(ctx, mix["batch"], mix["views"])
    calls, real = [], cb.convnext_block

    def record(x, *params, eps):
        out = real(x, *params, eps=eps)
        calls.append((x.clone(), tuple(p.detach().clone() for p in params), out.clone()))
        return out

    with mock.patch.object(cb, "convnext_block", record), torch.inference_mode():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    torch.cuda.synchronize()
    assert [tuple(c[0].shape) for c in calls] == [
        (16, 512 >> i, 640 >> i, 8 << i) for i in range(3)]
    for x, params, got in calls:
        assert _cnx_gap_share(got, x, params) <= 1.0, tuple(x.shape)
        torch.cuda.empty_cache()


def test_convnext_block_launches_at_each_eval_block_and_none_in_training(dev):
    """One eager eval forward of the ``fpn_convnext4`` model in bf16
    launches the kernel once a block (``convnext_block.launches``); an
    eager bf16 train step (B2 V3 64x128, recipe loss, Adam) and an eval
    forward in float32 launch it at none."""
    import dataclasses

    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import graft_entry
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs

    bf16 = dataclasses.replace(graft_entry.dtu_model_config("bfloat16"),
                               arch_mode="fpn_convnext4")
    batch = graft_entry.example_batch(device=dev, B=1, V=3, H=128, W=192)

    def eval_launches(cfg):
        model = checks.seeded_model(cfg, 3, dev)
        model.eval()
        before = _launches("convnext_block")
        with torch.inference_mode():
            model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        torch.cuda.synchronize()
        return _launched(before, "convnext_block")

    assert eval_launches(bf16) == 3
    assert eval_launches(dataclasses.replace(bf16, dtype="float32")) == 0
    model = checks.seeded_model(bf16, 3, dev)
    model.train()
    step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    before = _launches("convnext_block")
    with graphs.eager():
        step(checks.small_step_batch(dev))
    torch.cuda.synchronize()
    assert _launched(before, "convnext_block") == 0


def test_convnext_block_reads_the_live_weights_under_graph_replay(dev):
    """A captured graph of ``convnext_block`` replayed after every parameter
    changes in place gives the new block: the kernel packs the weights at
    every launch, so nothing goes stale."""
    _, params, x = _cnx_case(16, 31, 2, 40, 36, dev)
    with torch.no_grad():
        cb.convnext_block(x, *params)                                  # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = cb.convnext_block(x, *params)
        graph.replay()
        torch.cuda.synchronize()
        first = out.clone()
        assert torch.equal(first, cb.convnext_block(x, *params))
        for p in params:
            p.mul_(-0.5).add_(0.01)
        graph.replay()
        torch.cuda.synchronize()
        second = cb.convnext_block(x, *params)
        assert not torch.equal(first, second)
        assert torch.equal(out, second)


def test_convnext_block_refuses_what_it_does_not_take(dev):
    """No fallback on the card: ``convnext_block`` raises on a CPU tensor, a
    float32 or float16 input, a dim outside ``DIMS`` (4, 24, 64), a
    non-contiguous or misaligned x, a parameter of another shape, dtype or
    device, and under autograd."""
    _, params, x = _cnx_case(8, 3, 1, 12, 14, dev)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="device"):
            cb.convnext_block(x.cpu(), *(p.cpu() for p in params))
        for dtype in (torch.float32, torch.float16):
            with pytest.raises(ValueError, match="not supported"):
                cb.convnext_block(x.to(dtype), *params)
        for dim in (4, 24, 64):
            _, other, _ = _cnx_case(dim, 4, 1, 4, 4, dev)
            with pytest.raises(ValueError, match="not supported"):
                cb.convnext_block(torch.zeros((1, 4, 4, dim), device=dev,
                                              dtype=torch.bfloat16), *other)
        with pytest.raises(ValueError, match="contiguous"):
            cb.convnext_block(x.transpose(1, 2), *params)
        flat = torch.zeros(x.numel() + 1, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="aligned"):
            cb.convnext_block(flat[1:].view(x.shape), *params)
        with pytest.raises(ValueError, match="shapes"):
            cb.convnext_block(x, params[0][:, :4].contiguous(), *params[1:])
        with pytest.raises(ValueError, match="float32"):
            cb.convnext_block(x, *params[:-1], params[-1].to(torch.bfloat16))
        with pytest.raises(ValueError, match="on cpu"):
            cb.convnext_block(x, *params[:-1], params[-1].cpu())
    with pytest.raises(RuntimeError, match="autograd"):
        cb.convnext_block(x, *params)
