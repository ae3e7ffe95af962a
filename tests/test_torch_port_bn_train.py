"""The train-mode BatchNorm kernels' wrapper (``ops/kernels/bn_train.py``)
and the route through it, on the CPU.

- its plain version ``bn_train_ref`` against ``TorchBatchNorm.forward`` in
  training as the port computed it before the kernels (bit for bit: output,
  running statistics, ``num_batches_tracked`` and gradients), on a G 5
  input;
- the route: training on the CPU, and any call with ``sync_group`` set, take
  ``bn_train_ref``; where ``bn_train.route`` holds, ``TorchBatchNorm``
  calls ``bn_train`` on the input made contiguous; eval never calls either;
- the wrapper refuses what the kernels do not take (on the ``meta``
  device, which has the card's layout rules and runs no arithmetic);
- the slab plan, the comparison limits against float64 arithmetic, and
  ``checks.bn_train_modules`` against the calls of a train forward.
"""

from __future__ import annotations

from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks, graft_entry
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import layers as tl
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops.kernels import bn_train as bt

DTYPES = (torch.float32, torch.bfloat16)


def _parent_forward(bn, x, groups, relu):
    """``TorchBatchNorm.forward`` in training as the port had it before the
    kernels (without ``sync_group``), written out."""
    xf = x.float()
    G = groups
    N, C = x.shape[0], x.shape[-1]
    xg = xf.reshape(N // G, G, -1, C)
    n = xg.shape[0] * xg.shape[2]
    var, mean = torch.var_mean(xg, dim=(0, 2), correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + bn.eps)).reshape(x.shape)
    with torch.no_grad():
        m = tl.BN_MOMENTUM
        w = m ** torch.arange(G - 1, -1, -1, dtype=torch.float32, device=x.device)
        var_unb = var.reshape(G, C) * (n / max(n - 1, 1))
        bn.running_mean.mul_(m ** G).add_((1 - m) * (w[:, None] * mean.reshape(G, C)).sum(0))
        bn.running_var.mul_(m ** G).add_((1 - m) * (w[:, None] * var_unb).sum(0))
        bn.num_batches_tracked.add_(G)
    y = (y * bn.weight + bn.bias).to(x.dtype)
    return F.relu(y) if relu else y


def _bn(C, seed):
    """A train-mode ``TorchBatchNorm`` with parameters and statistics away
    from identity."""
    gen = torch.Generator().manual_seed(seed)
    bn = tl.TorchBatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=gen) * 1.5 + 0.5)
        bn.bias.copy_(torch.randn(C, generator=gen) * 0.2)
        bn.running_mean.copy_(torch.randn(C, generator=gen) * 0.2)
        bn.running_var.copy_(torch.rand(C, generator=gen) * 1.5 + 0.5)
    return bn


def _x(shape, dtype, seed, kind="plain"):
    """x ~ 2 N(0, 1) + 0.5; ``constant``: channel 1 constant; ``far_mean``:
    channel 0 at mean 300 over a spread of 3."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    if kind == "constant":
        x[..., 1] = 0.75
    elif kind == "far_mean":
        x[..., 0] = 300 + 3 * torch.randn(shape[:-1], generator=gen)
    return x.to(dtype)


def _state(bn):
    return [t.clone() for t in (bn.running_mean, bn.running_var, bn.num_batches_tracked)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
def test_plain_version_is_the_parents_train_batchnorm(dtype, relu):
    """``bn_train_ref`` through ``TorchBatchNorm`` in training on the CPU
    against the parent's train-mode forward, on a G 5 input (10 images,
    6x7, C 12): output, running statistics and ``num_batches_tracked``, and
    the gradients of x, weight and bias, bit for bit."""
    x = _x((10, 6, 7, 12), dtype, seed=3)
    dy = _x((10, 6, 7, 12), dtype, seed=4)
    got_bn, want_bn = _bn(12, seed=5), _bn(12, seed=5)
    xg, xw = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = got_bn(xg, 5, relu=relu)
    want = _parent_forward(want_bn, xw, 5, relu)
    assert got.dtype == dtype and torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(_state(got_bn), _state(want_bn)))
    assert got_bn.num_batches_tracked.item() == 5
    grads = torch.autograd.grad(got, (xg, got_bn.weight, got_bn.bias), dy)
    wants = torch.autograd.grad(want, (xw, want_bn.weight, want_bn.bias), dy)
    assert all(torch.equal(a, b) for a, b in zip(grads, wants))


def test_training_on_the_cpu_takes_the_plain_version():
    """A train-mode ``TorchBatchNorm`` on a CPU tensor calls
    ``bn_train_ref`` (without ``sync_group``) and never ``bn_train``."""
    bn, refs = _bn(8, seed=1), []
    real = bt.bn_train_ref

    def ref(*args, **kwargs):
        refs.append(kwargs.get("sync_group"))
        return real(*args, **kwargs)

    def kernel(*args):
        raise AssertionError("bn_train called on the CPU")

    with mock.patch.object(bt, "bn_train_ref", ref), mock.patch.object(bt, "bn_train", kernel):
        bn(_x((2, 3, 4, 8), torch.bfloat16, seed=2), relu=True)
    assert refs == [None]


@pytest.mark.parametrize("sync", [False, True], ids=["no_group", "sync_group"])
def test_sync_group_keeps_the_plain_version_where_the_kernels_would_run(sync):
    """Where ``bn_train.route`` holds (patched: the CPU has no card), a
    train-mode call with no ``sync_group`` goes to ``bn_train`` with the
    input made contiguous and every argument in place; one with
    ``sync_group`` set goes to ``bn_train_ref`` with the group, whose
    all-reduces run (patched to a world of one)."""
    bn, calls = _bn(8, seed=6), []
    group = object() if sync else None
    bn.sync_group = group
    x = _x((4, 5, 3, 8), torch.bfloat16, seed=7).transpose(1, 2)
    real = bt.bn_train_ref

    def kernel(x, *args):
        calls.append(("bn_train", x.is_contiguous(), args))
        return real(x, *args)

    def ref(x, *args, sync_group=None):
        calls.append(("bn_train_ref", sync_group, args))
        return real(x, *args, sync_group=sync_group)

    with mock.patch.object(bt, "route", lambda x: True), \
            mock.patch.object(bt, "bn_train", kernel), mock.patch.object(bt, "bn_train_ref", ref), \
            mock.patch.object(bt, "world_size", lambda g: 1), \
            mock.patch.object(bt, "all_reduce_sum", lambda t, g: t):
        y = bn(x, 2, relu=True)
    want = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.num_batches_tracked, 2,
            bn.eps, tl.BN_MOMENTUM, True)
    assert len(calls) == 1 and calls[0][0] == ("bn_train_ref" if sync else "bn_train")
    assert calls[0][1] is (group if sync else True)
    assert all(a is b or a == b for a, b in zip(calls[0][2], want))
    assert y.shape == x.shape


def test_eval_never_calls_bn_train():
    """An eval ``TorchBatchNorm`` and the flagship's eval forward (B1 V2
    64x64) call neither ``bn_train`` nor ``bn_train_ref``."""
    def never(*args, **kwargs):
        raise AssertionError("a train-mode BatchNorm ran in eval")

    model = MVS4Net(graft_entry.dtu_model_config("bfloat16"), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    batch = graft_entry.example_batch(1, 2, 64, 64, device="cpu")
    with mock.patch.object(bt, "bn_train", never), mock.patch.object(bt, "bn_train_ref", never), \
            torch.no_grad():
        _bn(8, seed=1).eval()(_x((2, 3, 4, 8), torch.float32, seed=2), relu=True)
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    assert checks.bn_train_modules(model) == 0


@pytest.mark.parametrize("case,refusal", [
    ("float16", "dtype"), ("transposed", "contiguous"), ("too wide", "C="),
    ("groups", "divisible"), ("bf16 weight", "float32"), ("bf16", "device"),
    ("float32", "device"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(case, refusal):
    """``bn_train`` off the CPU raises instead of falling back: a float16
    input, a non-contiguous one, more than ``MAX_CHANNELS`` channels, a
    batch the view groups do not divide, parameters that are not float32;
    on the ``meta`` device a call the kernels take passes every check and
    is refused only as not on the card."""
    C = bt.MAX_CHANNELS + 1 if case == "too wide" else 8
    dtype = {"float16": torch.float16, "float32": torch.float32}.get(case, torch.bfloat16)
    x = torch.zeros((4, 3, 5, C), dtype=dtype, device="meta")
    if case == "transposed":
        x = x.transpose(1, 2)
    w_dtype = torch.bfloat16 if case == "bf16 weight" else torch.float32
    params = (torch.ones(C, dtype=w_dtype, device="meta"),
              *(torch.zeros(C, device="meta") for _ in range(3)),
              torch.zeros((), dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match=refusal):
        bt.bn_train(x, *params, 3 if case == "groups" else 2, 1e-5, 0.9, True)
    assert not bt.route(x) or case in ("transposed", "groups", "bf16 weight")


@pytest.mark.parametrize("N,P,C,vw", [(30, 512 * 640, 8, 8), (48, 64 * 80, 8, 8),
                                      (4, 64, 64, 8), (2, 37 * 53, 12, 1), (2, 35, 300, 1),
                                      (1, 15, 2056, 8), (6, 1, 8, 4)])
def test_plan_covers_each_image_with_whole_slabs(N, P, C, vw):
    """``bn_train.plan``: the fewest slabs an image for at most
    ``MAX_ITERS`` pixel rows a thread, each slab whole rows of the lane
    grid (or the whole image), and about ``TARGET_CTAS`` CTAs or more
    where the call has that many rows of work."""
    pps, slabs = bt.plan(N, P, C, vw)
    rows = max(1, bt.THREADS // (C // vw))
    assert 1 <= pps <= P and pps * (slabs - 1) < P <= pps * slabs
    assert pps == P or pps % rows == 0
    assert pps <= rows * bt.MAX_ITERS
    if N * P >= rows * bt.TARGET_CTAS * bt.MAX_ITERS:
        assert N * slabs >= bt.TARGET_CTAS * 0.9


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,groups", [("plain", 5), ("constant", 1), ("far_mean", 5)])
def test_limits_hold_float32_arithmetic_against_float64(dtype, kind, groups):
    """The limits the card tests hold the kernels to (``bn_train.limit``,
    ``grad_limits``, ``running_limit``) hold the plain version's own
    float32 arithmetic against the same arithmetic in float64, forward,
    running statistics and backward, with room: they are not tighter than
    float32 itself."""
    x = _x((10, 9, 11, 16), dtype, seed=11, kind=kind)
    dy = _x((10, 9, 11, 16), dtype, seed=12)
    bn = _bn(16, seed=13)
    shapes = {}
    for prec in (torch.float32, torch.float64):
        xp = x.to(prec).requires_grad_(True)
        w, b = (t.detach().to(prec).requires_grad_(True) for t in (bn.weight, bn.bias))
        rm, rv = bn.running_mean.to(prec, copy=True), bn.running_var.to(prec, copy=True)
        z = bt.bn_train_ref(xp, w, b, rm, rv, torch.zeros((), dtype=torch.long), groups,
                            bn.eps, tl.BN_MOMENTUM, False)
        shapes[prec] = (z, *torch.autograd.grad(z, (xp, w, b), dy.to(prec)), rm, rv)
    (z32, dx32, dw32, db32, rm32, rv32), (z64, dx64, dw64, db64, rm64, rv64) = (
        shapes[torch.float32], shapes[torch.float64])
    dx_lim, dw_lim, db_lim = bt.grad_limits(dx32, dx64, x, dy, bn.weight, groups, bn.eps)
    rm_lim, rv_lim = bt.running_limit(bn.running_mean, bn.running_var, x, groups,
                                      tl.BN_MOMENTUM)
    for got, want, lim in ((z32, z64, bt.limit(z32, z64, x, bn.weight, bn.bias, groups, bn.eps)),
                           (dx32, dx64, dx_lim), (dw32, dw64, dw_lim), (db32, db64, db_lim),
                           (rm32, rm64, rm_lim), (rv32, rv64, rv_lim)):
        assert ((got.double() - want).abs() <= 0.5 * lim).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_check_bn_train_holds_the_plain_version_against_itself(dtype):
    """``checks.check_bn_train`` on the CPU, where the wrapper takes the
    plain version: every share 0 in float32; in bf16 only the output's
    rounding, at most half a bf16 ulp (half of ``limit``'s one), and
    ``num_batches_tracked`` moved by G."""
    bn = _bn(8, seed=21)
    x = _x((10, 4, 6, 8), dtype, seed=22)
    dy = _x((10, 4, 6, 8), dtype, seed=23)
    shares = checks.check_bn_train(x, dy, bn.weight, bn.bias, bn.running_mean,
                                   bn.running_var, 5, True)
    assert set(shares) == {"y", "running_mean", "running_var", "dx", "dweight", "dbias",
                           "max_share"}
    if dtype == torch.float32:
        assert shares["max_share"] == 0.0
    else:
        assert 0 < shares["y"] <= 0.5 and shares["running_mean"] == shares["running_var"] == 0


def test_flagship_train_forward_calls_each_train_batchnorm_once():
    """A train-mode forward of the flagship (B1 V5 64x64, bf16) calls
    ``TorchBatchNorm`` once at each of its 54 train-mode modules
    (``checks.bn_train_modules``: the count behind ``chip_smoke.py``'s
    ``bn_train`` launches a train step), the FPN's 11 with the 5 views as
    groups; in eval the count reads 0."""
    model = MVS4Net(graft_entry.dtu_model_config("bfloat16"), device="cpu",
                    generator=torch.Generator().manual_seed(0)).train()
    calls, real = [], tl.TorchBatchNorm.forward

    def record(self, x, groups=1, relu=False):
        calls.append((id(self), groups, relu))
        return real(self, x, groups, relu)

    batch = graft_entry.example_batch(1, 5, 64, 64, device="cpu")
    with mock.patch.object(tl.TorchBatchNorm, "forward", record), torch.no_grad():
        model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    assert len(calls) == len({c[0] for c in calls}) == checks.bn_train_modules(model) == 54
    assert sum(g == 5 for _, g, _ in calls) == 11 and all(relu for *_, relu in calls)
    assert checks.bn_train_modules(model.eval()) == 0
