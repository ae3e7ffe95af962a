"""The FPN top-down chain, differentiable, over kernel K2.

Counterpart of the JAX package's ``ops/pallas/topdown_fused.py``
``_fused_chain`` and its backward ``_fused_chain_bwd``: every level is one
K2 launch (``ops/kernels/topdown.py``), ``u = up2(intra) + 1x1(skip) + bi``
then ``o = 3x3(u)``, and each mid level's ``u`` feeds the next.

``TopDownChain`` is the ``torch.autograd.Function``. Its forward runs K2
once per level and saves only ``(intra, skips, weights)``. Its backward:

  1. re-derives every level's ``u`` with K2 (``u_only=True``: no 3x3, no
     ``o``);
  2. casts the output gradients to the working dtype;
  3. per level, finest first: ``du, dwo`` of the 3x3 from the convolution
     library's gradient calls, plus the gradient from the next level;
  4. ``dprev``, the adjoint of the align-corners upsample;
  5. ``dskip, dwi, dbi`` of the 1x1 and the bias.

``topdown_chain`` takes the Function in training, and in eval calls K2
directly with nothing saved.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from ..core.geometry import resize_align_corners_adjoint
from .kernels.topdown import topdown_level


def _forward(intra, skips, weights):
    outs = []
    cur = intra
    for i, (skip, (wi, bi, wo)) in enumerate(zip(skips, weights)):
        if i < len(skips) - 1:
            o, cur = topdown_level(cur, skip, wi, bi, wo, with_u=True)
        else:
            o = topdown_level(cur, skip, wi, bi, wo)
        outs.append(o)
    return tuple(outs)


def _split(flat):
    n = len(flat) // 4
    skips = flat[:n]
    weights = [tuple(flat[n + 3 * i: n + 3 * i + 3]) for i in range(n)]
    return skips, weights


class TopDownChain(torch.autograd.Function):
    """``apply(intra, *skips, *(wi, bi, wo) per level) -> (o per level)``:
    ``intra [N,Hh,Wh,64]``, skips finest-last in the working dtype, weights
    in the layouts of ``ops/kernels/topdown.py``."""

    @staticmethod
    def forward(ctx, intra, *flat):
        ctx.save_for_backward(intra, *flat)
        skips, weights = _split(flat)
        return _forward(intra, skips, weights)

    @staticmethod
    def backward(ctx, *grads):
        intra, *flat = ctx.saved_tensors
        skips, weights = _split(flat)
        dt = intra.dtype
        grads = [g.to(dt) for g in grads]

        us = []
        cur = intra
        for skip, (wi, bi, wo) in zip(skips, weights):
            cur = topdown_level(cur, skip, wi, bi, wo, u_only=True)
            us.append(cur)

        n = len(skips)
        d_skips, d_weights = [None] * n, [None] * n
        g_u = None
        for lvl in reversed(range(n)):
            skip, (wi, bi, wo), u = skips[lvl], weights[lvl], us[lvl]
            prev = intra if lvl == 0 else us[lvl - 1]
            wo_t = wo.to(dt)
            u_nchw = u.permute(0, 3, 1, 2)
            g_nchw = grads[lvl].permute(0, 3, 1, 2)
            du = conv2d_input(u_nchw.shape, wo_t, g_nchw, padding=1)
            dwo = conv2d_weight(u_nchw, wo_t.shape, g_nchw, padding=1)
            du = du.permute(0, 2, 3, 1)                       # [N, H, W, 64]
            if g_u is not None:
                du = du + g_u
            Ci, Cs = wi.shape[:2]
            du2 = du.reshape(-1, Ci)
            dwi = (du2.t() @ skip.reshape(-1, Cs)).reshape(wi.shape)
            dbi = du2.sum(0, dtype=torch.float32)
            d_skips[lvl] = (du2 @ wi.to(dt).reshape(Ci, Cs)).reshape(skip.shape)
            d_weights[lvl] = (dwi.to(wi.dtype), dbi.to(bi.dtype), dwo.to(wo.dtype))
            g_u = resize_align_corners_adjoint(du, prev.shape[1:3])
        return (g_u, *d_skips, *(w for lw in d_weights for w in lw))


def topdown_chain(
    intra: torch.Tensor,
    skips: Sequence[torch.Tensor],
    weights: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    *,
    train: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The top-down outputs ``(o2, o3, o4)``: through ``TopDownChain`` with
    ``train``, else K2 directly."""
    if train:
        return TopDownChain.apply(intra, *skips, *(w for lw in weights for w in lw))
    return _forward(intra, skips, weights)
