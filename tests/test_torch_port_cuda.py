"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there the repository's ``conftest.py``
(which configures JAX) is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
    relative_projection,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    topdown as k2,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    warp_cor as k1,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,G,src_hw", [
    (8, 4, None), (16, 4, None), (32, 8, None), (64, 8, None), (8, 2, (20, 28)),
])
def test_warp_cor_kernel_matches_plain(dev, dtype, C, G, src_hw):
    """K1 against ``warp_cor_ref`` on the card (tolerance: ``TOLERANCE``
    of the kernel module), on the four stages' (C, G) and on a source
    smaller than the reference, so that the sweep leaves the image."""
    B, H, W, D = 2, 48, 64, 4
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


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """No fallback: a CUDA tensor the kernel cannot take raises instead of
    being computed some other way."""
    src = torch.zeros((1, 8, 8, 12), device=dev)
    hypo = torch.ones((1, 2, 8, 8), device=dev)
    rel = torch.eye(4, device=dev)[None]
    with pytest.raises(ValueError, match="not supported"):
        k1.warp_cor(src, src, rel, hypo, 4)
    intra = torch.zeros((1, 4, 4, 64), device=dev)
    skip = torch.zeros((1, 8, 8, 8), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k2.topdown_level(intra, skip, torch.zeros((64, 8, 1, 1), device=dev),
                         torch.zeros(64, device=dev), torch.zeros((8, 64, 3, 3), device=dev))
