"""The patchify ConvNeXt block (``models/fpn.ConvNeXt4Block``) as one pass
(``csrc/convnext_block.cu``): the 2x2 stride-2 conv, the 7x7 conv of two
channels a group, the float32 LayerNorm, the GELU MLP, the layer scale and
the residual, from the block's input to its output in one launch.

The kernel rounds where the plain bf16 route does and nowhere else: the
2x2 conv's output ``inp`` once (the 7x7 conv's input and the residual), the
LayerNorm's output and the GELU's output (the A operands of the two GEMMs)
and the block's output; the 7x7 conv, the LayerNorm, the GEMMs' sums (the
tensor cores' float32 accumulation), the GELU (exact erf form), the layer
scale and the residual stay in float32. Weights and biases are rounded to
bf16 where the plain route casts them to the activations' dtype (all but
the LayerNorm's), from the float32 parameters at every launch, so a
captured graph reads them as they are at replay. ``inp``, the 7x7 conv's
output and the hidden activations never reach device memory. No TPU kernel
stood here: the JAX package's blocks are plain flax, as
:func:`convnext_block_ref` is plain PyTorch.

``route`` says where ``ConvNeXt4Block`` takes the kernel: on a CUDA tensor
in bf16 with ``dim`` in ``DIMS``, in eval with no autograd recording (no
backward is written). Everywhere else (training, the CPU, float32, other
widths) it takes the plain version. ``convnext_block`` launches the kernel
on a CUDA tensor and raises on any it does not take, a CPU tensor
included.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from .. import _build

_LAUNCH = _build.Kernel("convnext_block", "cnx_launch",
                        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float])

DTYPES = (torch.bfloat16,)
# the input widths the kernel takes (csrc/convnext_block.cu: its tiles and
# packed weights in shared memory)
DIMS = (8, 16, 32)
EPS = 1e-6
# the block's parameters as the kernel takes them, by their names in
# ``ConvNeXt4Block``
PARAMS = ("sconv.weight", "sconv.bias", "dwconv.weight", "dwconv.bias", "norm.weight",
          "norm.bias", "pwconv1.weight", "pwconv1.bias", "pwconv2.weight", "pwconv2.bias",
          "gamma")
# the ones the plain route uses as they are (float32): the LayerNorm's
UNROUNDED = ("norm.weight", "norm.bias")
TAPS = 49

# Kernel against the plain version computed in float32 with the weights
# rounded as the plain route rounds them (``limit``). The kernel rounds four
# times: inp, y and g to bf16, each by at most half a bf16 ulp (2^-8 of the
# value), and the output once; and it sums in float32 in another order than
# the reference (at most 2 K float32 ulps of the absolute terms a sum of K).
# To first order the output's error is a linear map of those errors: inp's
# through the 7x7 conv, the LayerNorm's Jacobian, the first GEMM, GELU's
# slope at h, the second GEMM and gamma, plus the residual; y's through the
# last four; g's through the second GEMM and gamma. A chain of three
# contractions (98, 2 dim and 4 dim terms) makes the worst case of those
# sums as large as the output itself, so the roundings are taken as
# independent errors of zero mean (round to nearest) with variance at most
# (2^-8 v)^2 / 3, the float32 sums' gaps as errors of that size too, and
# the variance each output gets is summed through the exact per-pixel
# first-order maps: the limit is ``SIGMAS`` of its square root (a gap
# beyond it has odds under 1e-14 for a Gaussian sum, and the variance is a
# bound), plus half a bf16 ulp of the larger result for the output's own
# rounding.
BF16_HALF_ULP = 2.0 ** -8
F32_ULP = 2.0 ** -23
SIGMAS = 8.0


def route(device_type: str, dtype, dim: int, train: bool) -> bool:
    """Whether a patchify ConvNeXt block on a tensor on ``device_type`` of
    ``dtype`` with ``dim`` input channels runs as the kernel; ``train``: the
    module is in training mode or autograd would record the call."""
    return device_type == "cuda" and dtype in DTYPES and dim in DIMS and not train


def _conv(x, weight, bias=None, stride=1, padding=0, groups=1):
    """2-D convolution of an NHWC tensor with an OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding, 1, groups)
    return y.permute(0, 2, 3, 1)


def convnext_block_ref(x, sw, sb, dw, db, lw, lb, w1, b1, w2, b2, gamma, eps: float = EPS):
    """Plain PyTorch version: ``x [N, H, W, dim]`` and the block's parameters
    in the order of ``PARAMS`` -> ``[N, H/2, W/2, 2 dim]`` in the dtype of
    ``x``, every parameter but the LayerNorm's cast to it: the 2x2 stride-2
    conv, the 7x7 conv with ``dim`` groups (padding 3), the LayerNorm in
    float32, the GELU MLP, ``gamma`` and the residual."""
    dt = x.dtype
    inp = _conv(x, sw.to(dt), sb.to(dt), 2)
    c = _conv(inp, dw.to(dt), db.to(dt), 1, 3, x.shape[-1])
    y = F.layer_norm(c.float(), c.shape[-1:], lw, lb, eps).to(dt)
    h = F.gelu(F.linear(y, w1.to(dt), b1.to(dt)))
    return inp + F.linear(h, w2.to(dt), b2.to(dt)) * gamma.to(dt)


def rounded(params):
    """The parameters (in the order of ``PARAMS``) in float32, each rounded to
    bf16 where the plain bf16 route rounds it."""
    return tuple(p.float() if name in UNROUNDED else p.to(torch.bfloat16).float()
                 for name, p in zip(PARAMS, params))


def stages(x, params, eps: float = EPS) -> SimpleNamespace:
    """The block on ``x`` in float32 with the weights as :func:`rounded` gives
    them and no rounding between: ``inp``, ``c`` (the 7x7 conv), ``rstd``
    and ``xh`` (the LayerNorm's normalised ``c``), ``y``, ``h`` (the first
    GEMM), ``g`` (GELU), ``z`` (the second GEMM) and ``out``."""
    sw, sb, dw, db, lw, lb, w1, b1, w2, b2, gamma = rounded(params)
    s = SimpleNamespace(inp=_conv(x.float(), sw, sb, 2))
    s.c = _conv(s.inp, dw, db, 1, 3, x.shape[-1])
    d = s.c - s.c.mean(-1, keepdim=True)
    s.rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    s.xh = d * s.rstd
    s.y = s.xh * lw + lb
    s.h = s.y @ w1.T + b1
    s.g = F.gelu(s.h)
    s.z = s.g @ w2.T + b2
    s.out = s.inp + gamma * s.z
    return s


def _gelu_slope(h):
    """gelu'(h) = Phi(h) + h phi(h), the exact form's derivative."""
    return (0.5 * (1.0 + torch.erf(h * 0.5 ** 0.5))
            + h * torch.exp(-0.5 * h * h) / (2 * torch.pi) ** 0.5)


def limit(got, x, params, eps: float = EPS, s=None) -> torch.Tensor:
    """The largest ``|got - want|`` allowed at each output between the kernel
    (``got``) and ``want``, :func:`stages`' ``out`` on ``x`` and ``params``
    (or ``s``, those stages), float32, shaped as ``want``: the bound of the
    module's comment, from the kernel's four roundings and its float32 sums."""
    s = stages(x, params, eps) if s is None else s
    sw, sb, dw, db, lw, lb, w1, b1, w2, b2, gamma = rounded(params)
    rv, e = BF16_HALF_ULP ** 2 / 3, F32_ULP        # a rounding's variance over v^2
    dim = x.shape[-1]
    c2, c4 = 2 * dim, 4 * dim
    _, ho, wo, _ = s.inp.shape
    # the per-pixel first-order maps: the LayerNorm's Jacobian L (c -> y),
    # M = diag(gamma) W2 diag(gelu'(h)) (h -> out), G = M W1 L (c -> out)
    eye = torch.eye(c2, device=s.c.device)
    L = (lw[:, None] * s.rstd[..., None]) * (eye - 1.0 / c2
                                             - s.xh[..., :, None] * s.xh[..., None, :] / c2)
    M = gamma[:, None] * w2 * _gelu_slope(s.h)[..., None, :]      # h -> out, [.., o, n]
    GT = M @ w1                                                     # y -> out
    G = GT @ L                                                      # c -> out
    # inp: its rounding and sconv's sum of 4 dim terms. out[p][o] takes
    # sum over groups g, inputs i and taps t of A[o, g, i, t] inp_err[p + t][2 g + i],
    # A = sum over a of G[o][2 g + a] dw[2 g + a][i][t], so its variance is
    # sum over g, a, b of G[o][2 g + a] G[o][2 g + b] K[g, a, b], K[g, a, b] =
    # sum over i, t of dw[2 g + a][i][t] dw[2 g + b][i][t] v_inp[p + t][2 g + i];
    # and the residual adds 1 to A at the centre tap of o's own channel
    v_inp = (rv * s.inp ** 2
             + (2 * 4 * dim * e * _conv(x.float().abs(), sw.abs(), sb.abs(), 2)) ** 2)
    v_pad = F.pad(v_inp, (0, 0, 3, 3, 3, 3))
    taps = torch.stack([v_pad[:, ky:ky + ho, kx:kx + wo] for ky in range(7) for kx in range(7)], -1)
    dwg = dw.reshape(dim, 2, 2 * TAPS)                              # [g, a, (i, t)]
    K = torch.einsum("...gk,gabk->...gab", taps.reshape(*taps.shape[:-2], dim, 2 * TAPS),
                     dwg[:, :, None] * dwg[:, None])
    Gg = G.reshape(*G.shape[:-1], dim, 2)                           # [.., o, g, a]
    var = torch.einsum("...oga,...gab,...ogb->...o", Gg, K, Gg)
    own = torch.arange(c2, device=G.device)
    centre = dw[:, :, 3, 3].reshape(dim, 2, 2)[own // 2, :, own % 2]    # [o, a]
    var += v_inp * (2 * (Gg[..., own, own // 2, :] * centre).sum(-1) + 1)
    # the 7x7 conv's sum of 98 terms
    s_c = 2 * 2 * TAPS * e * _conv(s.inp.abs(), dw.abs(), db.abs(), 1, 3, dim)
    var += (G ** 2 * (s_c ** 2)[..., None, :]).sum(-1)
    # y: its rounding and the LayerNorm's float32 arithmetic
    v_y = rv * s.y ** 2 + (4 * c2 * e * ((s.xh * lw).abs() + lb.abs())) ** 2
    var += (GT ** 2 * v_y[..., None, :]).sum(-1)
    # the first GEMM's sum of 2 dim terms
    s_h = 2 * c2 * e * (s.y.abs() @ w1.abs().T + b1.abs())
    var += (M ** 2 * (s_h ** 2)[..., None, :]).sum(-1)
    # g: its rounding and erf's
    v_g = rv * s.g ** 2 + (4 * e * s.g) ** 2
    var += v_g @ ((gamma[:, None] * w2) ** 2).T
    # the second GEMM's sum of 4 dim terms, the layer scale and the residual
    s_z = 2 * c4 * e * (s.g.abs() @ w2.abs().T + b2.abs())
    var += (gamma * s_z) ** 2 + (2 * e * (s.inp.abs() + (gamma * s.z).abs())) ** 2
    larger = torch.maximum(got.float().abs(), s.out.abs())
    return SIGMAS * var.sqrt() + BF16_HALF_ULP * larger


def limit_share(got, x, params, eps: float = EPS) -> float:
    """The largest ``|got - want| / limit`` over the outputs (at most 1 for
    the kernel), ``want`` :func:`stages`' ``out``. An output equal to
    ``want`` counts as 0; a gap that is not finite (a NaN or infinite
    output) counts as infinite."""
    s = stages(x, params, eps)
    gap = (got.float() - s.out).abs()
    share = torch.where(gap == 0, 0.0, gap / limit(got, x, params, eps, s))
    return share.nan_to_num(nan=float("inf")).max().item()


def convnext_block(x, *params, eps: float = EPS) -> torch.Tensor:
    """``x [N, H, W, dim]`` bf16, contiguous, ``dim`` in ``DIMS``, and the
    block's eleven float32 contiguous parameters in the order of ``PARAMS``
    -> the block's output ``[N, H/2, W/2, 2 dim]`` bf16; see
    :func:`convnext_block_ref` (the kernel keeps float32 where the plain bf16
    route rounds, so they differ within a few bf16 ulps). Raises on anything
    else."""
    _build.refuse_autograd("convnext_block", x, *params)
    if x.dim() != 4:
        raise ValueError(f"convnext_block: x {tuple(x.shape)} is not [N, H, W, dim]")
    N, H, W, dim = x.shape
    if len(params) != len(PARAMS):
        raise ValueError(f"convnext_block: {len(params)} parameters, want {len(PARAMS)}")
    c2, c4 = 2 * dim, 4 * dim
    shapes = ((c2, dim, 2, 2), (c2,), (c2, 2, 7, 7), (c2,), (c2,), (c2,), (c4, c2), (c4,),
              (c2, c4), (c2,), (c2,))
    for name, p, shape in zip(PARAMS, params, shapes):
        if tuple(p.shape) != shape:
            raise ValueError(f"convnext_block: shapes {name} {tuple(p.shape)}, x {tuple(x.shape)}")
        if p.dtype != torch.float32:
            raise ValueError(f"convnext_block: {name} must be float32, not {p.dtype}")
        if p.device != x.device:
            raise ValueError(f"convnext_block: {name} on {p.device}, x on {x.device}")
        if not p.is_contiguous():
            raise ValueError(f"convnext_block: {name} must be contiguous")
    if x.dtype not in DTYPES:
        raise ValueError(f"convnext_block: dtype {x.dtype} not supported")
    if dim not in DIMS:
        raise ValueError(f"convnext_block: dim={dim} not supported")
    if not x.is_contiguous():
        raise ValueError("convnext_block: x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("convnext_block: x must be 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"convnext_block: {N * H * W} pixels of {dim} channels not supported")
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    out = torch.empty((N, H // 2, W // 2, c2), dtype=x.dtype, device=x.device)
    if out.numel():
        _LAUNCH.launch(x.device, x, *params, out, N, H, W, dim, eps)
    return out
