"""The differentiable plane-sweep warp of the train path.

Counterpart of the JAX package's ``ops/warp_mxu.py:_warp_hybrid_ik``
(``homo_warp_mxu(..., hybrid=True)`` with the in-kernel-coordinates
backward): ``WarpIK.apply(src, rel_proj, hypo) -> [B, D, H, W, C]``.

- Forward: the exact bilinear gather (``core.geometry.grid_sample_2d`` at
  ``warp_coords``) under ``no_grad``. The JAX forward is an XLA scan, not a
  Pallas kernel, so plain PyTorch is its counterpart.
- Saved for backward: only ``(src, rel_proj, hypo)``, as the JAX
  ``_warp_hybrid_ik_fwd`` saves; the coordinates are recomputed.
- Backward: ``dsrc = K3(g, rel_proj, hypo)`` (``ops/kernels/warp_bwd.py``),
  cast to ``src.dtype``; none for the coordinates, which are stop-gradient.
"""

from __future__ import annotations

import torch

from ..core.geometry import grid_sample_2d, warp_coords
from .kernels.warp_bwd import warp_bwd


class WarpIK(torch.autograd.Function):
    """``src [B,Hs,Ws,C], rel_proj [B,4,4] f32, hypo [B,D,H,W] f32 ->
    [B,D,H,W,C]`` in the dtype of ``src``; gradient to ``src`` only."""

    @staticmethod
    def forward(ctx, src, rel_proj, hypo):
        ctx.save_for_backward(src, rel_proj, hypo)
        return grid_sample_2d(src, warp_coords(rel_proj, hypo))

    @staticmethod
    def backward(ctx, g):
        src, rel_proj, hypo = ctx.saved_tensors
        dsrc = warp_bwd(g.contiguous(), rel_proj, hypo, tuple(src.shape))
        return dsrc.to(src.dtype), None, None
