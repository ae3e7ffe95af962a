"""Train-mode BatchNorm with an optional ReLU, forward and backward
(``csrc/bn_train.cu``): the norm of every block in training
(``models/layers.TorchBatchNorm``), batch statistics per view group of the
folded batch.

For ``x [N, H, W, C]`` (contiguous, channels last, bf16 or float32) with
``G`` view groups (image ``n`` in group ``n % G``), the forward takes each
group's mean and biased variance per channel, writes
``relu(((x - mean) * rstd) * weight + bias)`` in float32 rounded once to the
dtype of ``x``, and moves the running statistics by the G momentum updates
in closed form, in place; the backward is the full BatchNorm backward
through the batch statistics, and ``dweight``, ``dbias``. Three launches a
direction: stats, finalize, apply; grad_reduce, grad_finalize, dx. It moves
16 bytes a bf16 element in all (x read twice and y written forward; x and
dy read twice and dx written backward), and autograd saves only ``x`` and
the ``[G, C]`` statistics. No TPU kernel stood here (XLA fused the norm
into its neighbours).

``bn_train`` launches the kernels on a CUDA tensor (through ``BNTrain``,
whose backward launches the other three) and uses the plain PyTorch
version ``bn_train_ref`` only for a tensor on the CPU. ``route`` says which
train-mode calls take it: ``TorchBatchNorm`` keeps ``bn_train_ref`` for
everything else (the ``sync_group`` path too).
"""

from __future__ import annotations

import ctypes

import torch

from ...parallel.distributed import all_reduce_sum, world_size
from .. import _build

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LAUNCH = _build.Kernel("bn_train", "bn_train_stats_launch",
                        [_P, _P, _I, _LL, _I, _I, _LL, _I])
_FINALIZE = _build.Kernel("bn_train", "bn_train_finalize_launch",
                          [_P] * 7 + [_I, _LL, _I, _I, _LL] + [_F] * 5)
_APPLY = _build.Kernel("bn_train", "bn_train_apply_launch",
                       [_P] * 6 + [_I, _LL, _I, _I, _I, _LL, _I, _I])
_GRAD_REDUCE = _build.Kernel("bn_train", "bn_train_grad_reduce_launch",
                             [_P] * 7 + [_I, _LL, _I, _I, _I, _LL, _I, _I])
_GRAD_FINALIZE = _build.Kernel("bn_train", "bn_train_grad_finalize_launch",
                               [_P] * 4 + [_I, _LL, _I, _I, _LL])
_DX = _build.Kernel("bn_train", "bn_train_dx_launch",
                    [_P] * 8 + [_I, _LL, _I, _I, _I, _LL, _I, _F, _I])

DTYPES = (torch.float32, torch.bfloat16)
# the widest C the kernels take (csrc/bn_train.cu MAX_CHANNELS)
MAX_CHANNELS = 4096
# kernel launches a call, forward and backward
LAUNCHES_PER_CALL = 6

# csrc/bn_train.cu's slab plan: THREADS threads a CTA, at most MAX_ITERS
# pixel rows a thread, about TARGET_CTAS CTAs a launch where the call is
# large enough; a constant of the shapes only, so the order of every sum is
# the same on any card
THREADS = 256
MAX_ITERS = 16
TARGET_CTAS = 1024


def plan(N: int, P: int, C: int, vw: int):
    """``(pps, slabs)``: the pixels of a CTA's slab and the slabs an image,
    for ``N`` images of ``P`` pixels of ``C`` channels moved ``vw`` at a
    time (the lane grid of ``csrc/bn_train.cu``: ``C // vw`` vectors a
    pixel, ``256 // (C // vw)`` pixel rows)."""
    rows = max(1, THREADS // (C // vw))
    iters = min(MAX_ITERS, max(1, -(-(N * P) // (rows * TARGET_CTAS))))
    pps = min(P, rows * iters)
    return pps, -(-P // pps)


def _vw(C: int, dtype, *tensors) -> int:
    """16 bytes a thread (8 bf16 or 4 float32 values) where C is a multiple
    of that and every tensor starts on 16 bytes; else 1."""
    vw = 8 if dtype == torch.bfloat16 else 4
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return vw if C % vw == 0 and aligned else 1


# Kernel against plain version (``limit``, ``grad_limits``,
# ``running_limit``): the two round differently (the statistics' sums in
# another order, the float64 merge, the running updates' powers), so each
# output may differ by one ulp of the larger of the two in the dtype of x
# (2^-7 relative in bf16: the two float32 values may fall on either side of
# a rounding boundary; none in float32), plus F32_ULPS float32 ulps of the
# terms that form it (its operands before any cancellation, and the
# statistics' relative errors carried into it), plus MEAN_ULPS of the mean's
# magnitude over the spread (each side rounds the mean once to float32,
# which x - mean then carries: large where the mean is far above the
# spread), and for a sum over the batch SUM_ULPS ulps of the sum of its
# terms' magnitudes (each side adds at most ~16 terms in a row and then in
# trees or in float64, so neither rounds more than ~log2 of the count
# times).
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
F32_ULPS = 16 * 2.0 ** -23
MEAN_ULPS = 2 * 2.0 ** -23
SUM_ULPS = 64 * 2.0 ** -23


def _groups(t, G):
    N, C = t.shape[0], t.shape[-1]
    return t.double().reshape(N // G, G, -1, C)


def _xhat(x, G, eps):
    """``(|xhat|, its error)`` in float64, ``[N/G, G, P, C]``: xhat = (x -
    mean) rstd of each group, its error ``MEAN_ULPS |mean| rstd + F32_ULPS
    (|xhat| + 1)`` (the mean's rounding; the subtraction's and rstd's
    relative errors; the statistics' errors over the spread)."""
    xg = _groups(x, G)
    var, mean = torch.var_mean(xg, dim=(0, 2), correction=0, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xh = ((xg - mean) * rstd).abs()
    return xh, MEAN_ULPS * mean.abs() * rstd + F32_ULPS * (xh + 1)


def limit(got, want, x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """The largest ``|got - want|`` allowed at each element of the forward
    output between the kernel and the plain version (or any other order of
    the same arithmetic), float32, shaped as ``x``: one ulp of the larger
    result in x's dtype, plus ``|w|`` times xhat's error (``_xhat``), plus
    ``F32_ULPS`` of ``|xhat w| + |b|`` (the affine map's roundings)."""
    xh, err = _xhat(x, groups, eps)
    w, b = weight.double().abs(), bias.double().abs()
    terms = w * err + F32_ULPS * (xh * w + b)
    larger = torch.maximum(got.float().abs(), want.float().abs())
    return ULP[x.dtype] * larger + terms.reshape(x.shape).float()


def grad_limits(got_dx, want_dx, x, dy, weight, groups: int, eps: float):
    """``(dx limit shaped as x, dweight limit [C], dbias limit [C])`` between
    the kernel's gradients and the plain version's, for a gradient ``dy``
    already masked by the ReLU. With ``a = |w| rstd``, the group means
    ``md = mean|dy|``, ``mdx = mean|dy xhat|`` and xhat's error ``e``
    (``_xhat``): ``dx = w rstd (dy - sum(dy)/n - xhat sum(dy xhat)/n)`` may
    differ by one ulp of the larger result in x's dtype, plus ``a (F32_ULPS
    (|dy| + md + |xhat| mdx) + e mdx + SUM_ULPS (md + |xhat| mdx))`` (its
    operands, xhat's error, the two sums); ``dweight`` by ``SUM_ULPS`` of the
    sum of ``|dy xhat|`` plus the sum of ``|dy| e``; ``dbias`` by
    ``SUM_ULPS`` of the sum of ``|dy|``."""
    xh, err = _xhat(x, groups, eps)
    xg = _groups(x, groups)
    var = torch.var(xg, dim=(0, 2), correction=0, keepdim=True)
    dyg = _groups(dy, groups).abs()
    n = xg.shape[0] * xg.shape[2]
    md = dyg.sum(dim=(0, 2), keepdim=True) / n
    mdx = (dyg * xh).sum(dim=(0, 2), keepdim=True) / n
    a = weight.double().abs() * torch.rsqrt(var + eps)
    terms = a * (F32_ULPS * (dyg + md + xh * mdx) + err * mdx + SUM_ULPS * (md + xh * mdx))
    larger = torch.maximum(got_dx.float().abs(), want_dx.float().abs())
    dx = ULP[x.dtype] * larger + terms.reshape(x.shape).float()
    C = x.shape[-1]
    dweight = SUM_ULPS * (dyg * xh).reshape(-1, C).sum(0) + (dyg * err).reshape(-1, C).sum(0)
    return dx, dweight.float(), (SUM_ULPS * dyg.reshape(-1, C).sum(0)).float()


def running_limit(old_mean, old_var, x, groups: int, momentum: float):
    """``(running_mean limit, running_var limit)``, ``[C]`` each, after one
    call on ``x`` from the running statistics ``old_mean`` and ``old_var``:
    ``F32_ULPS`` of ``m^G |old| + (1 - m) sum_v m^(G-1-v) |stat_v|`` with each
    group's mean or unbiased variance, plus for the mean the weighted sum of
    its own error (``MEAN_ULPS |mean| + F32_ULPS`` of the spread)."""
    xg = _groups(x, groups)
    var, mean = torch.var_mean(xg, dim=(0, 2), correction=0)
    n = xg.shape[0] * xg.shape[2]
    w = momentum ** torch.arange(groups - 1, -1, -1, dtype=torch.float64, device=x.device)

    def wsum(t):
        return (1 - momentum) * (w[:, None] * t).sum(0)

    m_g = momentum ** groups
    mean_lim = F32_ULPS * (m_g * old_mean.double().abs() + wsum(mean.abs())) + wsum(
        MEAN_ULPS * mean.abs() + F32_ULPS * var.sqrt())
    var_lim = F32_ULPS * (m_g * old_var.double().abs() + wsum(var * (n / max(n - 1, 1))))
    return mean_lim.float(), var_lim.float()


def bn_train_ref(x, weight, bias, running_mean, running_var, num_batches_tracked,
                 groups: int, eps: float, momentum: float, relu: bool, sync_group=None):
    """Plain PyTorch version, the train-mode BatchNorm as the port computed
    it before the kernels: statistics per view group of the folded batch
    (fold index ``b*V + v``, so the group axis is the inner one of
    ``reshape(N // G, G, ...)``) in float32, normalized with the biased
    variance; the running statistics take the G sequential momentum updates
    in closed form, ``m^G r + (1-m) sum_v m^(G-1-v) s_v``, with the unbiased
    variance; cast back to x's dtype, then the ReLU where ``relu``. With
    ``sync_group`` the statistics are those of the global batch: the batch
    sum and then the sum of squared deviations all-reduced over the group
    (differentiable)."""
    xf = x.float()
    G = groups
    N, C = x.shape[0], x.shape[-1]
    if N % G:
        raise ValueError(f"batch {N} not divisible by view groups {G}")
    xg = xf.reshape(N // G, G, -1, C)
    n = xg.shape[0] * xg.shape[2]
    if sync_group is None:
        var, mean = torch.var_mean(xg, dim=(0, 2), correction=0, keepdim=True)
    else:
        n *= world_size(sync_group)
        mean = all_reduce_sum(xg.sum(dim=(0, 2), keepdim=True), sync_group) / n
        dev = xg - mean
        var = all_reduce_sum((dev * dev).sum(dim=(0, 2), keepdim=True), sync_group) / n
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    with torch.no_grad():
        m = momentum
        w = m ** torch.arange(G - 1, -1, -1, dtype=torch.float32, device=x.device)
        var_unb = var.reshape(G, C) * (n / max(n - 1, 1))
        running_mean.mul_(m ** G).add_((1 - m) * (w[:, None] * mean.reshape(G, C)).sum(0))
        running_var.mul_(m ** G).add_((1 - m) * (w[:, None] * var_unb).sum(0))
        num_batches_tracked.add_(G)
    y = (y * weight + bias).to(x.dtype)
    return torch.relu(y) if relu else y


def route(x) -> bool:
    """Whether a train-mode call on ``x`` (with no ``sync_group``) takes the
    kernels: a CUDA tensor of a dtype in ``DTYPES`` with 1 to
    ``MAX_CHANNELS`` channels."""
    return (x.device.type == "cuda" and x.dtype in DTYPES and x.dim() >= 2
            and 1 <= x.shape[-1] <= MAX_CHANNELS)


def _check(x, weight, bias, running_mean, running_var, num_batches_tracked, groups):
    if x.dim() < 2:
        raise ValueError("bn_train: x has no batch and channel axes")
    N, C = x.shape[0], x.shape[-1]
    if x.dtype not in DTYPES:
        raise ValueError(f"bn_train: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError("bn_train: x is not contiguous")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"bn_train: C={C} not supported")
    if groups < 1 or N % groups:
        raise ValueError(f"bn_train: batch {N} not divisible by view groups {groups}")
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"bn_train: {name} {tuple(t.shape)}, x {tuple(x.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"bn_train: {name} must be contiguous float32, not {t.dtype}")
    if num_batches_tracked.dtype != torch.int64 or num_batches_tracked.numel() != 1:
        raise ValueError("bn_train: num_batches_tracked must be one int64")
    for t in (weight, bias, running_mean, running_var, num_batches_tracked):
        if t.device != x.device:
            raise ValueError(f"bn_train: a parameter on {t.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"bn_train: unsupported device {x.device}")


def _shape(x, groups):
    N, C = x.shape[0], x.shape[-1]
    return N, x.numel() // (N * C), C, groups


def _forward(x, weight, bias, running_mean, running_var, num_batches_tracked, groups, eps,
             momentum, relu):
    """The three forward launches: ``(y, mean [G, C], rstd [G, C])``."""
    N, P, C, G = _shape(x, groups)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    vw = _vw(C, x.dtype, x, y)
    pps, slabs = plan(N, P, C, vw)
    part = torch.empty(N * slabs * 2 * C, dtype=torch.float32, device=x.device)
    stats = torch.empty((3, G, C), dtype=torch.float32, device=x.device)
    mean, rstd, var = stats
    n = (N // G) * P
    bf16 = int(x.dtype == torch.bfloat16)
    _LAUNCH.launch(x.device, x, part, N, P, C, vw, pps, bf16)
    _FINALIZE.launch(x.device, part, mean, rstd, var, running_mean, running_var,
                     num_batches_tracked, N, P, C, G, pps, float(eps), float(momentum),
                     float(momentum ** G), float(1 - momentum), float(n / max(n - 1, 1)))
    _APPLY.launch(x.device, x, y, mean, rstd, weight, bias, N, P, C, G, vw, pps,
                  int(bool(relu)), bf16)
    return y, mean, rstd


def _backward(dy, x, weight, bias, mean, rstd, groups, relu, need_dx):
    """The three backward launches: ``(dx or None, dweight [C], dbias [C])``."""
    N, P, C, G = _shape(x, groups)
    vw = _vw(C, x.dtype, x, dy)
    pps, slabs = plan(N, P, C, vw)
    part = torch.empty(N * slabs * 2 * C, dtype=torch.float32, device=x.device)
    sums = torch.empty((2, G, C), dtype=torch.float32, device=x.device)
    dweight = torch.empty(C, dtype=torch.float32, device=x.device)
    dbias = torch.empty(C, dtype=torch.float32, device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    _GRAD_REDUCE.launch(x.device, x, dy, mean, rstd, weight, bias, part, N, P, C, G, vw, pps,
                        int(bool(relu)), bf16)
    _GRAD_FINALIZE.launch(x.device, part, sums, dweight, dbias, N, P, C, G, pps)
    dx = None
    if need_dx:
        dx = torch.empty_like(x, memory_format=torch.contiguous_format)
        _DX.launch(x.device, x, dy, dx, mean, rstd, weight, bias, sums, N, P, C, G, vw, pps,
                   int(bool(relu)), float(1.0 / ((N // G) * P)), bf16)
    return dx, dweight, dbias


class BNTrain(torch.autograd.Function):
    """``x [N, ..., C]`` contiguous, bf16 or float32, on the card ->
    the train-mode BatchNorm (and ReLU) of x in its dtype; the running
    statistics and ``num_batches_tracked`` move in place. Gradients to x,
    weight and bias, each by a kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked, groups,
                eps, momentum, relu):
        y, mean, rstd = _forward(x, weight, bias, running_mean, running_var,
                                 num_batches_tracked, groups, eps, momentum, relu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.relu = groups, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dweight, dbias = _backward(dy.contiguous(), x, weight, bias, mean, rstd,
                                       ctx.groups, ctx.relu, ctx.needs_input_grad[0])
        return dx, dweight, dbias, None, None, None, None, None, None, None


def bn_train(x, weight, bias, running_mean, running_var, num_batches_tracked, groups: int,
             eps: float, momentum: float, relu: bool) -> torch.Tensor:
    """``x [N, ..., C]`` float32 or bf16, contiguous, ``N`` a multiple of
    ``groups``; ``weight``, ``bias``, ``running_mean``, ``running_var``
    float32 ``[C]``; ``num_batches_tracked`` one int64 -> the train-mode
    BatchNorm of x (and its ReLU where ``relu``) in the dtype of x, the
    running statistics updated in place; see :func:`bn_train_ref` (the
    kernels sum in another order, so results may differ from it by
    ``limit``). The kernels on a CUDA tensor, the plain version on a CPU
    one; raises on what the kernels do not take."""
    if x.device.type == "cpu":
        return bn_train_ref(x, weight, bias, running_mean, running_var, num_batches_tracked,
                            groups, eps, momentum, relu)
    _check(x, weight, bias, running_mean, running_var, num_batches_tracked, groups)
    return BNTrain.apply(x, weight, bias, running_mean, running_var, num_batches_tracked,
                         groups, eps, momentum, relu)
