"""Kernel ``deform_conv`` (``ops/kernels/deform_conv.py``), a DCN head's
taps and 9C-to-C contraction, and the route to it, on the CPU.

- ``route`` takes the kernel only in eval with no autograd recording, on
  the card, in bf16, at C 8, 16, 32 or 64; training, the CPU, float32 and
  C 4 take the plain version;
- the plain version ``deform_conv_ref`` equals the deformable conv as
  ``DeformConv2d`` computed it before the kernel, bit for bit, in bf16 and
  float32 (the CPU tests against the JAX package see no change);
- ``DeformConv2d`` on the CPU, in eval and in training, computes the plain
  version and launches nothing; it tells ``route`` the call is training
  wherever autograd would record it, through the input, the weight or the
  offset conv's parameters;
- the wrapper ``deform_conv`` raises on a CPU tensor (the route alone takes
  the plain version);
- ``limit_share`` reads a NaN or infinite output as beyond the limit;
- the kernel's arithmetic emulated on the CPU (each float32 sample rounded
  once to bf16, a float32 contraction, one rounding of the output) lies
  within ``deform_conv.limit`` of the plain version in float32
  (``limit_share``), at offsets inside and outside the image.
"""

from __future__ import annotations

import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core.geometry import (
    grid_sample_2d,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.fpn import DeformConv2d
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    deform_conv as dc,
)


@pytest.mark.parametrize("device,dtype,C,train,want", [
    ("cuda", torch.bfloat16, 8, False, True),
    ("cuda", torch.bfloat16, 16, False, True),
    ("cuda", torch.bfloat16, 32, False, True),
    ("cuda", torch.bfloat16, 64, False, True),
    ("cuda", torch.bfloat16, 4, False, False),
    ("cuda", torch.bfloat16, 24, False, False),
    ("cuda", torch.bfloat16, 128, False, False),
    ("cuda", torch.bfloat16, 8, True, False),
    ("cuda", torch.float32, 8, False, False),
    ("cuda", torch.float16, 8, False, False),
    ("cpu", torch.bfloat16, 8, False, False),
])
def test_route_takes_the_kernel_only_in_eval_on_the_card_in_bf16(device, dtype, C, train, want):
    assert dc.route(device, dtype, C, train) is want


def _former_deform_conv(x, off, weight):
    """``DeformConv2d.forward`` after its offset conv, as the port had it
    before the kernel."""
    N, H, W, C = x.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    taps = []
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        px = gx + dx + off[..., 2 * t + 1].float()
        py = gy + dy + off[..., 2 * t].float()
        taps.append(grid_sample_2d(x, torch.stack([px, py], dim=-1)))
    w = weight.permute(2, 3, 1, 0).reshape(9 * C, -1)
    return torch.cat(taps, dim=-1) @ w.to(x.dtype)


def _head(C, spread, seed, dtype=torch.bfloat16, N=2, H=7, W=9):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((N, H, W, C), generator=gen).relu_().to(dtype)
    off = (torch.randn((N, H, W, 18), generator=gen) * spread).to(dtype)
    weight = torch.randn((C, C, 3, 3), generator=gen) * (9 * C) ** -0.5
    return x, off, weight


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [4, 8, 16])
def test_plain_version_equals_the_former_deform_conv(dtype, C):
    x, off, weight = _head(C, 1.5, C, dtype)
    assert torch.equal(dc.deform_conv_ref(x, off, weight), _former_deform_conv(x, off, weight))


def test_wrapper_raises_on_a_cpu_tensor():
    x, off, weight = _head(8, 0.5, 5)
    with pytest.raises(ValueError, match="device"):
        dc.deform_conv(x, off, weight)


@pytest.mark.parametrize("train", [False, True])
def test_deform_conv2d_takes_the_plain_version_on_the_cpu(train):
    gen = torch.Generator().manual_seed(3)
    head = DeformConv2d(8, 8)
    head.reset_parameters(gen)
    with torch.no_grad():
        head.conv_offset.weight.normal_(0.0, 0.5, generator=gen)
    head.train(train)
    x, _, _ = _head(8, 0.0, 4)
    before = _build.launch_counts()
    with torch.set_grad_enabled(train):
        got = head(x)
        off = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), head.conv_offset.weight.to(x.dtype),
            head.conv_offset.bias.to(x.dtype), padding=1).permute(0, 2, 3, 1)
        want = _former_deform_conv(x, off, head.weight)
    assert torch.equal(got, want)
    assert got.requires_grad is train
    assert _build.launch_counts() == before


@pytest.mark.parametrize("x_grad,weight_grad,offset_grad,train", [
    (False, False, False, False),
    (True, False, False, True),
    (False, True, False, True),
    (False, False, True, True),
])
def test_deform_conv2d_routes_as_training_where_autograd_would_record(
        monkeypatch, x_grad, weight_grad, offset_grad, train):
    """An eval head with grad enabled: the call counts as training if the
    input, the deformable weight or the offset conv's parameters (through
    the offsets) require grad."""
    head = DeformConv2d(8, 8)
    head.reset_parameters(torch.Generator().manual_seed(6))
    head.eval()
    head.weight.requires_grad_(weight_grad)
    for p in head.conv_offset.parameters():
        p.requires_grad_(offset_grad)
    x = _head(8, 0.0, 7)[0].requires_grad_(x_grad)
    seen, real = [], dc.route
    monkeypatch.setattr(dc, "route", lambda *a: seen.append(a[3]) or real(*a))
    with torch.enable_grad():
        head(x)
    assert seen == [train]


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_limit_share_reads_a_non_finite_output_beyond_the_limit(bad):
    x, off, weight = _head(8, 0.5, 8)
    got = dc.deform_conv_ref(x.float(), off.float(),
                             weight.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert dc.limit_share(got, x, off, weight) <= 1.0
    got[0, 3, 4, 5] = bad
    assert dc.limit_share(got, x, off, weight) > 1.0


@pytest.mark.parametrize("spread", [0.3, 4.0, 40.0])
@pytest.mark.parametrize("C", [8, 64])
def test_kernel_arithmetic_lies_within_the_limit(C, spread):
    """The kernel's roundings on the CPU: each float32 sample to bf16 once,
    the contraction in float32 (in another order than the plain version's
    matmul), the output to bf16 once."""
    x, off, weight = _head(C, spread, 100 + C)
    wq = weight.to(torch.bfloat16).float()
    want = dc.deform_conv_ref(x.float(), off.float(), wq)
    s = dc.samples(x.float(), off.float()).to(torch.bfloat16).double()
    w = wq.permute(2, 3, 1, 0).reshape(9 * C, -1).double()
    got = (s @ w).float().to(torch.bfloat16)
    assert dc.limit_share(got, x, off, weight) <= 1.0
    assert (got.float() - want).abs().max() > 0            # the roundings do show
