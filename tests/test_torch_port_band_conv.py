"""Kernel K6 (``ops/kernels/band_conv.py``) and the eval route through it,
against the JAX package on the CPU.

- K6's plain version against the TPU kernel ``band_conv3x3`` in interpret
  mode, on its channels-in-sublanes layout;
- the port's eval ``ConvBnReLU`` (3x3) and ``ConvBnReLU3D`` ((1,3,3)), which
  fold the BatchNorm and reach ``band_conv``, against the flax blocks at
  ``train=False``;
- which blocks take the route: eval mode, stride 1, 3x3, at most 16
  channels in and out; everything else keeps the convolution library.

Inputs are made with numpy from a seed and handed to both frameworks;
float32 throughout, tolerances stated per test.
"""

from __future__ import annotations

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import layers as jl
from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.pallas.reg_band_proto import (
    band_conv3x3,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    band_conv as k6,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import jax_params

from test_torch_port_ops import _bn_sd, _random_variables


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ci,co", [(3, 8), (4, 8), (8, 8), (16, 16)])
def test_band_conv_ref_matches_pallas_band_conv3x3(ci, co):
    """``band_conv_ref`` against ``band_conv3x3(..., interpret=True)`` (N 2,
    H 32, W 96 zero-padded to 128 lanes; the layouts converted as
    tests/test_packed_conv.py does): atol 1e-5 on O(1) outputs (the 9·Ci
    products summed in another order)."""
    rng = np.random.default_rng(ci * 100 + co)
    N, H, W = 2, 32, 96
    x = rng.standard_normal((N, H, W, ci)).astype(np.float32)
    K = (rng.standard_normal((3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, co).astype(np.float32)
    bias = rng.normal(0.0, 0.2, co).astype(np.float32)
    x_cw = jnp.pad(jnp.swapaxes(jnp.asarray(x), 2, 3), ((0, 0),) * 3 + ((0, 128 - W),))
    want = band_conv3x3(x_cw, jnp.asarray(K), jnp.asarray(scale), jnp.asarray(bias),
                        w_real=W, interpret=True)
    want = np.swapaxes(np.asarray(want), 2, 3)[:, :, :W]
    got = k6.band_conv_ref(_t(x), _t(K.transpose(3, 2, 0, 1)), _t(scale), _t(bias))
    assert got.shape == (N, H, W, co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_band_conv_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor ``band_conv`` is its plain version, bf16 included
    (weights rounded to bf16, float32 sums, one rounding at the end), and
    counts no launch."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 9, 13, 5)).astype(np.float32)).to(torch.bfloat16)
    w = _t(rng.standard_normal((7, 5, 3, 3)).astype(np.float32) * 0.2)
    s, b = _t(rng.uniform(0.5, 2.0, 7).astype(np.float32)), _t(rng.normal(0, 0.2, 7).astype(np.float32))
    before = _build.launch_counts()
    got = k6.band_conv(x, w, s, b)
    assert _build.launch_counts() == before and got.dtype == torch.bfloat16
    assert torch.equal(got, k6.band_conv_ref(x, w, s, b))
    acc = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2),
                                     w.to(torch.bfloat16).float(), padding=1)
    want = torch.relu(acc.permute(0, 2, 3, 1) * s + b).to(torch.bfloat16)
    assert torch.equal(got, want)


BLOCK_CASES = [
    # (name, flax module, port module, input shape, conv-weight transform)
    ("conv_3_8", jl.ConvBnReLU(8, 3), tl.ConvBnReLU(3, 8, 3), (2, 12, 20, 3), jax_params._conv2d),
    ("conv_8_8", jl.ConvBnReLU(8, 3), tl.ConvBnReLU(8, 8, 3), (2, 12, 20, 8), jax_params._conv2d),
    ("conv_16_16", jl.ConvBnReLU(16, 3), tl.ConvBnReLU(16, 16, 3), (2, 10, 14, 16),
     jax_params._conv2d),
    ("c133_4_8", jl.ConvBnReLU3D(8, kernel=(1, 3, 3)), tl.ConvBnReLU3D(4, 8, (1, 3, 3)),
     (6, 8, 10, 4), jax_params._conv3d_as_2d),
    ("c133_8_8", jl.ConvBnReLU3D(8, kernel=(1, 3, 3)), tl.ConvBnReLU3D(8, 8, (1, 3, 3)),
     (8, 8, 12, 8), jax_params._conv3d_as_2d),
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_eval_blocks_through_band_conv_match_flax(case):
    """The port's eval blocks on K6's route (the BatchNorm folded into
    ``scale = weight·rsqrt(var + eps)``, ``bias = bias - mean·scale``)
    against the flax blocks at ``train=False``, with random running
    statistics carried by ``utils/jax_params.py``'s layouts: float32, atol
    and rtol 1e-5; each forward goes through ``band_conv`` once."""
    _, jmod, tmod, shape, transform = case
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    vs = _random_variables(jmod, jnp.asarray(x), train=False, seed=shape[-1])
    tmod.load_state_dict({"conv.weight": _t(transform(vs["params"]["Conv_0"]["kernel"])),
                          **_bn_sd(vs, "bn.")})
    want = jmod.apply(vs, jnp.asarray(x), train=False)
    with mock.patch.object(tl, "band_conv", wraps=tl.band_conv) as spy:
        got = tmod.eval()(_t(x))
    assert spy.call_count == 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_route_follows_mode_shape_and_width():
    """K6's route is fixed by the module's shape and mode and the
    activations' dtype: an eval 3x3 or (1,3,3) stride-1 block with at most
    ``BAND_CONV_MAX_CHANNELS[dtype]`` channels in and out (32 in float32, 64
    in bf16) takes it; the same block in training (batch statistics), a
    wider block, a stride-2 or 5x5 block and a 3x3x3 block do not, and
    their outputs are the unfused route's."""
    assert tl.BAND_CONV_MAX_CHANNELS == {torch.float32: 32, torch.bfloat16: 64}
    rng = np.random.default_rng(2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        (tl.ConvBnReLU(8, 16, 3), (2, 8, 8, 8), f32, True),
        (tl.ConvBnReLU3D(4, 8, (1, 3, 3)), (4, 8, 8, 4), f32, True),
        (tl.ConvBnReLU(16, 32, 3), (2, 8, 8, 16), f32, True),
        (tl.ConvBnReLU(32, 64, 3), (2, 8, 8, 32), f32, False),
        (tl.ConvBnReLU(64, 16, 3), (2, 8, 8, 64), f32, False),
        (tl.ConvBnReLU(8, 8, 3, 2), (2, 8, 8, 8), f32, False),
        (tl.ConvBnReLU(8, 8, 5), (2, 8, 8, 8), f32, False),
        (tl.ConvBnReLU3D(8, 8, (1, 3, 3), (1, 2, 2)), (4, 8, 8, 8), f32, False),
        (tl.ConvBnReLU3D(8, 8, depth=2), (4, 8, 8, 8), f32, False),
        (tl.ConvBnReLU(32, 32, 3), (2, 8, 8, 32), bf16, True),
        (tl.ConvBnReLU(64, 64, 3), (2, 8, 8, 64), bf16, True),
        (tl.ConvBnReLU(64, 96, 3), (2, 8, 8, 64), bf16, False),
        (tl.ConvBnReLU(32, 64, 5, 2), (2, 8, 8, 32), bf16, False),
    ]
    for module, shape, dtype, on_route in cases:
        module.conv.reset_parameters(torch.Generator().manual_seed(0))
        x = _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        for training in (True, False):
            module.train(training)
            with mock.patch.object(tl, "band_conv", wraps=tl.band_conv) as spy, \
                    torch.no_grad():
                module(x)
            assert spy.call_count == int(on_route and not training), (module, shape, training)


@pytest.mark.parametrize("shape,dtype,want", [
    ((16, 64, 80, 64, 64), torch.bfloat16, "tensor cores cip 64 nt 8"),
    ((16, 64, 80, 3, 8), torch.bfloat16, "tensor cores cip 8 nt 1"),
    ((2, 19, 33, 96, 16), torch.bfloat16, "bf16 direct"),
    ((2, 19, 33, 16, 72), torch.bfloat16, "bf16 direct"),
])
def test_plan_names_the_route_and_launch_shape(shape, dtype, want):
    """``band_conv.plan`` names the bf16 route a call takes: the tensor
    cores with Ci padded to 8, 16, 32 or 64 and Co to 8 n-tiles at most,
    else the direct form. (The float32 launch shape comes from the kernel's
    library: ``tests/test_torch_port_cuda.py::
    test_band_conv_plan_names_the_float32_launch_shape``.)"""
    assert k6.plan(*shape, dtype) == want
