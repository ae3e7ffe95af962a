"""Kernel ``norm_act`` (``ops/kernels/norm_act.py``), the eval BatchNorm +
ReLU after a library convolution, and the route through it, on the CPU.

- its plain version against the eval BatchNorm as the port computed it
  before the kernel (bit for bit: the CPU tests against the JAX package see
  no change), against the folded arithmetic the kernel does and against
  ``F.batch_norm``, in bf16 and float32, with and without ReLU, on 4-D and
  5-D inputs;
- ``TorchBatchNorm.eval_norm`` calls the wrapper for every eval tensor,
  made contiguous, and the wrapper refuses a dtype or width the kernel
  does not take;
- the flagship DTU model's eval forward at B1 V4 256x320 in bf16 and
  float32: the wrapper is called once at each eval BatchNorm that is not
  folded into K6 (``checks.norm_act_modules``), at none in train mode.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks, graft_entry
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import (
    norm_act as na,
)

DTYPES = (torch.float32, torch.bfloat16)


def _bn(C: int, seed: int) -> tl.TorchBatchNorm:
    """An eval ``TorchBatchNorm`` with statistics and affine parameters away
    from identity, as a trained network's are."""
    gen = torch.Generator().manual_seed(seed)
    bn = tl.TorchBatchNorm(C).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=gen) * 1.5 + 0.5)
        bn.bias.copy_(torch.randn(C, generator=gen) * 0.2)
        bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.2)
        bn.running_var.copy_(torch.rand(C, generator=gen) * 1.5 + 0.5)
    return bn


def _args(bn, x, relu):
    return (x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, relu)


def assert_within_kernel_tolerance(got, want, x, bn):
    """``|got - want|`` within ``norm_act.limit`` at every element: the
    folded form against the unfolded one, as the kernel against its plain
    version (``tests/test_torch_port_cuda.py``)."""
    gap = (got.float() - want.float()).abs()
    lim = na.limit(got, want, *_args(bn, x, True)[:-1])
    assert (gap <= lim).all(), (gap - lim).max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("C", [3, 8, 16, 64, 72])
@pytest.mark.parametrize("lead", [(2, 5, 7), (2, 3, 5, 7)], ids=["4d", "5d"])
def test_norm_act_ref_matches_eval_batchnorm(dtype, relu, C, lead):
    """``norm_act_ref`` and ``TorchBatchNorm`` in eval (which takes it on
    the CPU) against the eval transform written out as the port had it,
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` in float32, cast back,
    then ``F.relu``: bit for bit. Against the folded form the kernel
    computes (``relu(x * scale + shift)``, ``TorchBatchNorm.folded``) and
    against ``F.batch_norm``: within ``assert_within_kernel_tolerance``."""
    bn = _bn(C, seed=C)
    x = (torch.randn((*lead, C), generator=torch.Generator().manual_seed(C + 1)) * 2).to(dtype)
    with torch.no_grad():
        y = (x.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        before = (y * bn.weight + bn.bias).to(dtype)
        before = F.relu(before) if relu else before
        got = na.norm_act_ref(*_args(bn, x, relu))
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, before)
        assert torch.equal(bn(x, relu=relu), before)
        assert torch.equal(na.norm_act(*_args(bn, x, relu)), before)
        scale, shift = bn.folded()
        folded = x.float() * scale + shift
        folded = (torch.relu(folded) if relu else folded).to(dtype)
        assert_within_kernel_tolerance(got, folded, x, bn)
        lib = F.batch_norm(x.float().movedim(-1, 1), bn.running_mean, bn.running_var,
                           bn.weight, bn.bias, False, 0.0, bn.eps).movedim(1, -1)
        lib = (torch.relu(lib) if relu else lib).to(dtype)
        assert_within_kernel_tolerance(got, lib, x, bn)


@pytest.mark.parametrize("case,refusal", [
    ("contiguous bf16", "device"), ("contiguous float32", "device"), ("transposed", "device"),
    ("float16", "dtype"), ("too wide", "C="), ("cpu", None),
])
def test_eval_norm_route_follows_device_dtype_layout_and_width(case, refusal):
    """``TorchBatchNorm.eval_norm`` calls the wrapper for every tensor, made
    contiguous (a transposed one too), and the wrapper refuses what the
    kernel cannot take instead of falling back: a float16 tensor or more
    than ``MAX_CHANNELS`` channels. On the ``meta`` device, which has the
    card's layout rules and runs no arithmetic, a tensor the kernel takes
    passes every check and is refused only as not on the card; a CPU tensor
    takes the plain version."""
    C = na.MAX_CHANNELS + 1 if case == "too wide" else 8
    dtype = {"contiguous float32": torch.float32, "float16": torch.float16}.get(case,
                                                                              torch.bfloat16)
    device = "cpu" if case == "cpu" else "meta"
    bn = tl.TorchBatchNorm(C).eval().to(device)
    x = torch.zeros((2, 4, 6, C), dtype=dtype, device=device)
    if case == "transposed":
        x = x.transpose(1, 2)
    contiguous, real = [], na.norm_act

    def spy(y, *rest):
        contiguous.append(y.is_contiguous())
        return real(y, *rest)

    with mock.patch.object(na, "norm_act", spy), torch.no_grad():
        if refusal is None:
            assert torch.equal(bn(x, relu=True), na.norm_act_ref(*_args(bn, x, True)))
        else:
            with pytest.raises(ValueError, match=refusal):
                bn(x, relu=True)
    assert contiguous == [True]


def _norm_names(model):
    return {id(m.weight): name for name, m in model.named_modules()
            if isinstance(m, tl.TorchBatchNorm)}


def _wrapper_calls(model, batch):
    """The BatchNorms (by module name) and inputs of each ``norm_act`` call
    in one forward of ``model``."""
    names, calls, real = _norm_names(model), [], na.norm_act

    def record(x, weight, *rest):
        calls.append((names[id(weight)], x.dtype, x.shape[-1], rest[-1]))
        return real(x, weight, *rest)

    with mock.patch.object(na, "norm_act", record):
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    return calls


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dtu_eval_forward_calls_the_wrapper_at_each_library_route_batchnorm(dtype):
    """The flagship DTU model (``graft_entry.dtu_model_config``) in eval at
    B1 V4 256x320: one wrapper call, with the ReLU fused, at each eval
    BatchNorm of ``checks.norm_act_modules`` (39 in bf16, 41 in float32,
    where K6 folds fewer layers), none at a block folded into K6, in the
    activations' dtype."""
    dt = getattr(torch, dtype)
    model = MVS4Net(graft_entry.dtu_model_config(dtype), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    batch = graft_entry.example_batch(1, 4, 256, 320, device="cpu")
    with torch.no_grad():
        calls = _wrapper_calls(model, batch)
    folded = {f"{name}.bn" for name, m in model.named_modules()
              if isinstance(m, (tl.ConvBnReLU, tl.ConvBnReLU3D)) and m.on_band_conv(dt)}
    called = [name for name, *_ in calls]
    assert len(calls) == checks.norm_act_modules(model, dt) == {torch.bfloat16: 39,
                                                                  torch.float32: 41}[dt]
    assert len(set(called)) == len(called) and not folded & set(called)
    assert all(d == dt and relu for _, d, _, relu in calls)


def test_no_wrapper_call_in_train_mode_or_at_group_norm():
    """A train-mode forward of the flagship (B1 V3 128x192, float32) calls
    the wrapper at no BatchNorm, and ``checks.norm_act_modules`` reads 0
    there; the ``gn`` variant in eval calls it at no GroupNorm block (its
    FPN has none to call) and as often as ``norm_act_modules`` says."""
    model = MVS4Net(graft_entry.dtu_model_config("float32"), device="cpu",
                    generator=torch.Generator().manual_seed(0)).train()
    batch = graft_entry.example_batch(1, 3, 128, 192, device="cpu")
    assert _wrapper_calls(model, batch) == []
    assert checks.norm_act_modules(model, torch.float32) == 0
    gn = MVS4Net(dataclasses.replace(graft_entry.dtu_model_config("float32"), gn=True),
                 device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        calls = _wrapper_calls(gn, batch)
    assert not any(name.startswith("feature.") for name, *_ in calls)
    assert len(calls) == checks.norm_act_modules(gn, torch.float32)
