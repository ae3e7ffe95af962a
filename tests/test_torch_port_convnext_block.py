"""Kernel ``convnext_block`` (``ops/kernels/convnext_block.py``), a whole
patchify ConvNeXt block, and the route to it, on the CPU.

- ``route`` takes the kernel only in eval with no autograd recording, on
  the card, in bf16, at dim 8, 16 or 32; training, the CPU, float32 and
  other widths take the plain version;
- ``ConvNeXt4Block`` tells ``route`` the call is training wherever
  autograd would record it, through the input or any parameter;
- the plain version ``convnext_block_ref`` equals the block as
  ``ConvNeXt4Block`` computed it before the kernel, bit for bit, in bf16 and
  float32, and ``ConvNeXt4Block`` on the CPU, in eval and in training,
  computes it and launches nothing, and still matches the JAX package's
  block (output and gradients, as ``test_torch_port_variants_modules.py``
  holds every module);
- the wrapper ``convnext_block`` raises on a CPU tensor;
- ``limit_share`` reads a NaN or infinite output as beyond the limit;
- the kernel's arithmetic emulated on the CPU (its four roundings to bf16,
  float32 between) lies within ``convnext_block.limit`` of the plain
  version in float32; the same emulation with the 7x7 kernel transposed,
  or without the residual, lies far beyond it.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from test_torch_port_variants_modules import _rand, _run

from benchmark import harness
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import fpn as jfpn
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.fpn import ConvNeXt4Block
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.layers import conv2d_nhwc
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    convnext_block as cb,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import jax_params as jp


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the cases run many small CPU ops, which
    a process's full thread pool slows ~50x when several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("device,dtype,dim,train,want", [
    ("cuda", torch.bfloat16, 8, False, True),
    ("cuda", torch.bfloat16, 16, False, True),
    ("cuda", torch.bfloat16, 32, False, True),
    ("cuda", torch.bfloat16, 4, False, False),
    ("cuda", torch.bfloat16, 24, False, False),
    ("cuda", torch.bfloat16, 64, False, False),
    ("cuda", torch.bfloat16, 8, True, False),
    ("cuda", torch.float32, 8, False, False),
    ("cuda", torch.float16, 8, False, False),
    ("cpu", torch.bfloat16, 8, False, False),
])
def test_route_takes_the_kernel_only_in_eval_on_the_card_in_bf16(device, dtype, dim, train, want):
    assert cb.route(device, dtype, dim, train) is want


def _block(dim, seed, N=2, H=14, W=18, dtype=torch.bfloat16):
    """A ``ConvNeXt4Block`` in eval with the benchmark's seeded weights
    (``harness.make_weights``: ``gamma`` and the LayerNorm weight N(0, 1), as
    in ``eval_convnext4_bf16``), its parameters in the order of
    ``cb.PARAMS``, and a ReLU'd input (a stem's output) in ``dtype``."""
    block = ConvNeXt4Block(dim).eval()
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in block.state_dict().items()}
    block.load_state_dict(harness.make_weights(shapes, seed, "cpu"))
    x = torch.randn((N, H, W, dim), generator=torch.Generator().manual_seed(seed)).relu_()
    return block, tuple(block.get_parameter(n) for n in cb.PARAMS), x.to(dtype)


def _former_block(block, x):
    """``ConvNeXt4Block.forward`` as the port had it before the kernel."""
    inp = conv2d_nhwc(x, block.sconv.weight, block.sconv.bias, 2)
    c = conv2d_nhwc(inp, block.dwconv.weight, block.dwconv.bias, 1, 3, groups=block.dim)
    return inp + block._mlp(c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dim,H,W", [(8, 14, 18), (16, 9, 13), (32, 8, 10)])
def test_plain_version_equals_the_former_block(dtype, dim, H, W):
    block, params, x = _block(dim, dim + H, H=H, W=W, dtype=dtype)
    with torch.no_grad():
        assert torch.equal(cb.convnext_block_ref(x, *params), _former_block(block, x))


def test_wrapper_raises_on_a_cpu_tensor():
    _, params, x = _block(8, 1)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        cb.convnext_block(x, *params)


@pytest.mark.parametrize("train", [False, True])
def test_block_takes_the_plain_version_on_the_cpu(monkeypatch, train):
    block, _, x = _block(16, 5)
    block.train(train)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(cb, "convnext_block", refuse)
    before = _build.launch_counts()
    with torch.set_grad_enabled(train):
        got = block(x)
        want = _former_block(block, x)
    assert torch.equal(got, want)
    assert got.requires_grad is train
    assert _build.launch_counts() == before


@pytest.mark.parametrize("x_grad,params_grad,train", [
    (False, False, False),
    (True, False, True),
    (False, True, True),
])
def test_block_routes_as_training_where_autograd_would_record(monkeypatch, x_grad, params_grad,
                                                              train):
    """An eval block with grad enabled: the call counts as training if the
    input or the parameters require grad."""
    block, params, x = _block(8, 6)
    for p in params:
        p.requires_grad_(params_grad)
    seen, real = [], cb.route
    monkeypatch.setattr(cb, "route", lambda *a: seen.append(a[3]) or real(*a))
    with torch.enable_grad():
        block(x.requires_grad_(x_grad))
    assert seen == [train]


@pytest.mark.parametrize("train", [False, True])
def test_block_matches_jax(train):
    """The block on the CPU in float32, in eval and in training (the plain
    version either way), against the JAX package's ``ConvNeXt4Block``:
    output and gradients."""
    _run(jfpn.ConvNeXt4Block(8), ConvNeXt4Block(8), [_rand(16, 2, 12, 16, 8)],
         lambda t: jp._convnext_block_entries(t, "m", "m", True), train=train, has_train=False)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulated_kernel(x, params, transposed=False, residual=True, eps=cb.EPS):
    """The kernel's arithmetic on the CPU: inp, the LayerNorm's output and
    GELU's output rounded to bf16, float32 between, the output rounded once;
    with ``transposed``, the 7x7 kernel's rows and columns swapped; without
    ``residual``, no ``inp`` added."""
    sw, sb, dw, db, lw, lb, w1, b1, w2, b2, gamma = cb.rounded(params)
    if transposed:
        dw = dw.transpose(2, 3)
    inp = _bf16(cb._conv(x.float(), sw, sb, 2))
    c = cb._conv(inp, dw, db, 1, 3, x.shape[-1])
    d = c - c.mean(-1, keepdim=True)
    y = _bf16(d * torch.rsqrt((d * d).mean(-1, keepdim=True) + eps) * lw + lb)
    g = _bf16(F.gelu(y @ w1.T + b1))
    z = gamma * (g @ w2.T + b2)
    return (inp + z if residual else z).to(torch.bfloat16)


@pytest.mark.parametrize("dim,H,W", [(8, 26, 30), (16, 18, 22), (32, 14, 14)])
def test_emulated_kernel_lies_within_the_limit(dim, H, W):
    """Two seeds a width: each within the limit, and the plain version in
    float32 (``stages``) equal to ``convnext_block_ref`` in float32 on the
    rounded weights within float32 rounding."""
    for seed in range(2):
        _, params, x = _block(dim, 10 * dim + seed, H=H, W=W)
        with torch.no_grad():
            assert cb.limit_share(_emulated_kernel(x, params), x, params) <= 1.0
            want = cb.convnext_block_ref(x.float(), *cb.rounded(params))
            got = cb.stages(x, params).out
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("fault", ["transposed", "no_residual"])
@pytest.mark.parametrize("dim", [8, 32])
def test_a_faulty_kernel_lies_far_beyond_the_limit(dim, fault):
    _, params, x = _block(dim, 3 * dim, H=14, W=18)
    with torch.no_grad():
        got = _emulated_kernel(x, params, transposed=fault == "transposed",
                               residual=fault != "no_residual")
        assert cb.limit_share(got, x, params) > 10.0


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_limit_share_reads_a_non_finite_output_beyond_the_limit(bad):
    _, params, x = _block(8, 9, H=6, W=8)
    with torch.no_grad():
        got = _emulated_kernel(x, params)
        got[0, 1, 2, 3] = bad
        assert cb.limit_share(got, x, params) == float("inf")
