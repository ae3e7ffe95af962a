"""K2's ``u_only`` mode (``ops/kernels/topdown.py``) on the CPU: the plain
version's ``u`` alone against the ``u`` of ``with_u``, against the TPU
kernel's ``_run_kernel_v4(..., with_u=True)`` in Pallas interpret mode, and
the top-down chain's ``autograd.Function``, whose backward re-derives ``u``
with it, against autograd through the plain chain.

Inputs are made with numpy from a seed and handed to both frameworks. JAX
runs on the CPU, as the JAX package's own tests run it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu.ops.pallas.topdown_fused import (
    _run_kernel_v4,
    level_fusable,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import topdown_chain
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    topdown as k2,
)

LEVELS = [(32, 32), (16, 16), (8, 8)]


def _level_inputs(cs, co, N, Hh, Wh, seed):
    """numpy ``intra [N,Hh,Wh,64]``, ``skip [N,2Hh,2Wh,Cs]`` and the
    weights in the JAX package's HWIO layouts."""
    rng = np.random.default_rng(seed)
    intra = rng.standard_normal((N, Hh, Wh, 64)).astype(np.float32)
    skip = rng.standard_normal((N, 2 * Hh, 2 * Wh, cs)).astype(np.float32)
    wi = (rng.standard_normal((1, 1, cs, 64)) * cs ** -0.5).astype(np.float32)
    bi = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((3, 3, 64, co)) / 24).astype(np.float32)
    return intra, skip, wi, bi, wo


def _port_args(intra, skip, wi, bi, wo, dtype=torch.float32):
    """The port's arguments: NHWC activations in ``dtype``, OIHW float32
    weights."""
    return (torch.from_numpy(intra).to(dtype), torch.from_numpy(skip).to(dtype),
            torch.from_numpy(wi.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bi),
            torch.from_numpy(wo.transpose(3, 2, 0, 1).copy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lvl", range(3))
def test_u_only_ref_equals_with_u(dtype, lvl):
    """``topdown_level_ref(u_only=True)`` returns the ``u`` of
    ``with_u=True``, bit for bit, at each level's (Cs, Co); ``o`` of
    ``with_u`` is the level's plain output."""
    cs, co = LEVELS[lvl]
    args = _port_args(*_level_inputs(cs, co, 2, 4 << lvl, 6 << lvl, seed=lvl), dtype)
    o, u = k2.topdown_level_ref(*args, with_u=True)
    u_only = k2.topdown_level_ref(*args, u_only=True)
    assert u_only.dtype == dtype and u_only.shape == (2, 8 << lvl, 12 << lvl, 64)
    assert torch.equal(u_only, u)
    assert torch.equal(o, k2.topdown_level_ref(*args))


@pytest.mark.parametrize("lvl", range(3))
def test_u_only_ref_matches_pallas_v4_u(lvl):
    """The plain ``u_only`` against the ``u`` of the TPU kernel's launcher
    ``_run_kernel_v4(..., with_u=True)`` (Pallas interpret mode) at the
    smallest shape ``level_fusable`` takes (half-resolution 8 x 8, N = 1),
    float32. atol 2e-5 / rtol 1e-5: the TPU kernel resizes the width first
    (an einsum) and the height inside, the plain version the rows first;
    the sums differ in float32 rounding only."""
    cs, co = LEVELS[lvl]
    inputs = _level_inputs(cs, co, 1, 8, 8, seed=10 + lvl)
    assert level_fusable(inputs[1].shape, (8, 8), 64)
    _, want = _run_kernel_v4(*map(jnp.asarray, inputs), interpret=True, with_u=True)
    got = k2.topdown_level_ref(*_port_args(*inputs), u_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_u_only_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors ``topdown_level(u_only=True)`` is the plain version and
    launches nothing."""
    args = _port_args(*_level_inputs(16, 16, 1, 4, 8, seed=3))
    before = k2.launches
    assert torch.equal(k2.topdown_level(*args, u_only=True),
                       k2.topdown_level_ref(*args, u_only=True))
    assert k2.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_function_matches_plain_autograd_on_cpu(dtype):
    """``TopDownChain`` (its backward re-deriving every level's ``u`` with
    ``u_only``) against autograd through ``topdown_level_ref``: outputs and
    the gradients of intra, the skips, wi, bi, wo within
    ``checks.CHAIN_TOLERANCE`` (``checks.check_chain_backward``), on 2
    images of half-resolution 4 x 6."""
    leaves, grads = checks.chain_inputs(2, 4, 6, dtype, "cpu", torch.Generator().manual_seed(5))
    result = checks.check_chain_backward(leaves, grads)
    assert result["max_rel_diff"] <= checks.CHAIN_TOLERANCE[dtype]


def test_chain_backward_rederives_u_with_u_only(monkeypatch):
    """The chain's backward asks K2 for ``u`` alone, once per level: no 3x3
    and no ``o`` where only ``u`` is needed."""
    calls = []
    level = topdown_chain.topdown_level

    def spy(*args, **kw):
        calls.append(kw)
        return level(*args, **kw)

    monkeypatch.setattr(topdown_chain, "topdown_level", spy)
    leaves, grads = checks.chain_inputs(1, 4, 6, torch.float32, "cpu",
                                        torch.Generator().manual_seed(6))
    outs = topdown_chain.TopDownChain.apply(*[x.requires_grad_() for x in leaves])
    n_forward = len(calls)
    torch.autograd.backward(outs, grads)
    assert n_forward == 3
    assert calls[n_forward:] == [{"u_only": True}] * 3
