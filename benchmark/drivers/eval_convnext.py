"""Driver ``eval_convnext``: ``eval_throughput`` on a configuration with the
patchify ConvNeXt pyramid (``arch_mode`` ``fpn_convnext4``), held to the
ConvNeXt reference (``reference/mvster_convnext.py``).

``run`` and ``control`` are ``eval_throughput``'s, called with the
ConvNeXt ``Net`` in the place of ``reference.mvster.Net``
(``compare.Net``) for the call only. Two of its counts are FPN4's, and are
put right for this pyramid:

- ``flops_per_iter``: FPN4's stem stages ``conv1``-``conv3`` taken out
  and the three ConvNeXt blocks put in (``counts/convnext.py``);
- ``kernel_pieces``: without the K6 rows of ``conv1.x``-``conv3.x``, the
  FPN4 layers this pyramid does not have (K6 runs on ``conv0.0``,
  ``conv0.1`` and each stage's Reg2D ``conv0``).

A traced run then profiles ``profile_iters`` eager forwards of the same
model on the pool's batches, after the window and its check, as
``eval_dcn`` does (its ``profile_heads``, read over the program's
``mvster.convnext`` ranges: the span ``convnext`` of
``models/fpn.ConvNeXt4Block`` under a profiler). ``res["convnext"]``
holds ``bound_ms``, the blocks' bound a forward, and with the profile
``stem_s``, the device seconds of the kernels launched inside those
ranges, ``forward_s``, the device seconds of every kernel of those
forwards, and ``iters``. A program without the span gives no ``stem_s``.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import compare, harness
from benchmark.counts import convnext
from benchmark.reference import mvster_convnext

BASE = harness.load_module(harness.find("drivers", "eval_throughput", ".py"))
# a copy of eval_dcn's module of its own, its range name set to this pyramid's
PROFILE = harness.load_module(harness.find("drivers", "eval_dcn", ".py"))
PROFILE.RANGE = "mvster.convnext"
# FPN4's K6 layers that the ConvNeXt pyramid does not run
FPN4_ONLY = tuple(f"K6 band conv conv{lvl}." for lvl in (1, 2, 3))


@contextlib.contextmanager
def _convnext_reference():
    saved = compare.Net
    compare.Net = mvster_convnext.Net
    try:
        yield
    finally:
        compare.Net = saved


def run(ctx, fault=None):
    """``eval_throughput.run`` against the ConvNeXt reference, with its
    counts put right (module docstring)."""
    with _convnext_reference():
        res = BASE.run(ctx, fault)
    mix, cfg = ctx.traffic, ctx.config
    shape = (mix["batch"], mix["views"], mix["height"], mix["width"])
    stem = convnext.totals(convnext.blocks(*shape, cfg["fpn_base_channel"], cfg["dtype"]))
    res["flops_per_iter"] += stem["flops"] - convnext.fpn4_stages_flops(cfg, *shape)
    res["kernel_pieces"] = kernel_pieces(res["kernel_pieces"])
    res["convnext"] = {"bound_ms": stem["bound_ms"]}
    if ctx.trace and torch.device(ctx.device).type == "cuda":
        prof = PROFILE.profile_heads(ctx)
        res["convnext"].update(forward_s=prof["forward_s"], iters=prof["iters"])
        if "heads_s" in prof:
            res["convnext"]["stem_s"] = prof["heads_s"]
    return res


def control(ctx, mode: str):
    """``eval_throughput.control`` against the ConvNeXt reference."""
    with _convnext_reference():
        return BASE.control(ctx, mode)


def kernel_pieces(pieces):
    """``roofline.kernel_pieces`` of the eval forward less FPN4's K6 rows."""
    return [p for p in pieces if not p["name"].startswith(FPN4_ONLY)]
