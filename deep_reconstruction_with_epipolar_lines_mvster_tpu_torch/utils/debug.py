"""Numeric debug dumps: the reference's cv2 / Open3D debug windows as
``.npy`` files.

Counterpart of the JAX package's ``utils/debug.py`` (reference
``--debug_model`` bits 0-7, ``MVS4Net.py:85-191``,
``mvs4net_utils.py:1054-1124``). ``debug_dump_forward`` reruns one forward
of the port, captures the same intermediates and writes each, batch element
0, to ``<outdir>/debug/<tag>_<name>.npy`` in float32, under the JAX
package's names:

  0  ``input_imgs``, and ``feat_<flax module path>.__call__[0]`` for the
     4-D outputs the JAX package captures with flax's
     ``capture_intermediates``: every conv + norm + ReLU block of the
     pyramid, the regularizers and ASFF (the block's output, its norm's
     output and, for a 2-D convolution, the convolution's), the top-down
     pathway's inner and output convs (``_TopDown_0.Conv_0..6``) and
     Reg2D's score conv; the flax paths come from the port's parameter
     table (``utils/jax_params.py``)
  1  ``{stage}_depth``
  2  ``{stage}_hypo_depth``
  3  ``{stage}_attn_weight`` (after the softmax)
  4  ``{stage}_mono_depth`` (stages 2-4, train forward with ``mono``)
  5  ``{stage}_warped_src{v}``: each source view's image, resized to the
     stage, warped onto the stage's hypotheses (kernel K4 on the card)
  6  ``{stage}_cor_weight_src{v}``: its per-view weights,
     ``softmax_D(sum_C (ref - warped)^2 / attn_temp) / sqrt(3)`` (the
     port's correlation, K4 on the card)
  7  ``{stage}_attn_logits``: ``log(attn_weight + 1e-12)``

The rerun leaves the model as it was: its train/eval mode and its
BatchNorm statistics (a train-mode rerun updates them) are put back.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def get_powers(n: int) -> List[str]:
    """Set-bit indices of ``n`` as strings (reference get_powers,
    train_mvs4.py:112-113)."""
    return [str(p) for p, v in enumerate(bin(n)[:1:-1]) if int(v)]


def _flax_names(model) -> Dict[str, str]:
    """Port module path -> the JAX package's flax module path, for every
    module the parameter table names and for the blocks that hold them
    (the parent of a mapped module maps to the flax parent)."""
    from .jax_params import _entries

    cfg = model.cfg
    backbone = ("Checkpoint" if cfg.remat else "") + (
        "FPN4_0" if cfg.arch_mode == "fpn" else "FPN4ConvNeXt_0")
    flat = {f"{backbone}/kernel": None}
    if cfg.mono:
        flat["MonoDepthDecoder_0/kernel"] = None
    names: Dict[str, str] = {}
    for _, flax_path, torch_key, _ in _entries(flat, cfg, cfg.num_stages):
        t, f = torch_key.rsplit(".", 1)[0], flax_path.rsplit("/", 1)[0]
        names.setdefault(t, f)
        if "." in t and "/" in f:
            names.setdefault(t.rsplit(".", 1)[0], f.rsplit("/", 1)[0])
    return names


def _block_parts(block, x, view_groups: int):
    """``[(port child name, value), ...]`` of a conv + norm + ReLU block on
    input ``x``: its convolution's output where that is a 2-D convolution
    (flax captures no 5-D value), and its norm's output, recomputed with
    the convolution library (the K6 route folds them away)."""
    from ..models.layers import (
        ConvBnReLU,
        ConvBnReLU3D,
        DeconvBnReLU3D,
        conv2d_nhwc,
        conv3d_ndhwc,
    )

    if isinstance(block, ConvBnReLU):
        w = block.conv.weight
        c = conv2d_nhwc(x, w, block.conv.bias, stride=block.stride, padding=w.shape[-1] // 2)
        if block.gn is not None:
            return [("conv", c), ("gn", block.gn(c))]
        return [("conv", c), ("bn", block.bn(c, view_groups))]
    if isinstance(block, ConvBnReLU3D):
        (kd, kh, kw), w = block.kernel, block.conv.weight
        if kd == 1 and block.stride[0] == 1:
            c = conv2d_nhwc(x, w[:, :, 0], stride=block.stride[1:], padding=(kh // 2, kw // 2))
            return [("conv", c), ("bn", block.bn(c))]
        N, H, W, C = x.shape
        y = conv3d_ndhwc(x.reshape(N // block.depth, block.depth, H, W, C), w,
                         stride=block.stride, padding=(kd // 2, kh // 2, kw // 2))
        return [("bn", block.bn(y.reshape(-1, *y.shape[2:])))]
    if isinstance(block, DeconvBnReLU3D):
        w = block._modules["0"].weight[:, :, 0].to(x.dtype)
        c = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, 2, 1, 1).permute(0, 2, 3, 1)
        return [("0", c), ("1", block._modules["1"](c))]
    return []


def _capture_features(model, record):
    """Register the bit-0 hooks on ``model``; returns their handles.
    ``record(flax_path, tensor)`` receives each captured value."""
    from ..models.fpn import NADCN
    from ..models.layers import (
        ConvBnReLU,
        ConvBnReLU3D,
        DeconvBnReLU3D,
        GroupNorm,
        TorchBatchNorm,
        conv2d_nhwc,
    )
    from ..models.reg import Reg2D

    names = _flax_names(model)
    blocks = (ConvBnReLU, ConvBnReLU3D, DeconvBnReLU3D)
    recomputed = set()
    handles = []

    def block_hook(path):
        def hook(module, args, kwargs, out):
            vg = kwargs.get("view_groups", args[1] if len(args) > 1 else 1)
            record(names[path], out)
            for child, value in _block_parts(module, args[0], vg):
                if f"{path}.{child}" in names:
                    record(names[f"{path}.{child}"], value)
        return hook

    def out_hook(flax_path, fn=lambda o: o):
        def hook(module, args, out):
            record(flax_path, fn(out))
        return hook

    for path, module in model.named_modules():
        if isinstance(module, blocks) and path in names:
            handles.append(module.register_forward_hook(block_hook(path), with_kwargs=True))
            recomputed.update(f"{path}.{c}" for c in ("conv", "bn", "gn", "0", "1"))
        elif isinstance(module, Reg2D) and f"{path}.prob" in names:
            handles.append(module.register_forward_hook(
                out_hook(names[f"{path}.prob"], lambda o: o[..., None])))
    for path, module in model.named_modules():
        if (isinstance(module, (TorchBatchNorm, GroupNorm)) and path in names
                and path not in recomputed):
            handles.append(module.register_forward_hook(out_hook(names[path])))

    # the top-down pathway: the inner convs of the stem's outputs, the
    # output convs (before any DCN head)
    feature = model.feature
    if "feature.inner1" in names:
        stems = {}
        for i in range(4):
            stage = feature._modules[f"conv{i}"]
            last = stage[-1] if isinstance(stage, torch.nn.Sequential) else stage
            handles.append(last.register_forward_hook(
                lambda m, a, o, i=i: stems.__setitem__(i, o)))

        def topdown(module, args, outs):
            for skip, inner in ((2, "inner1"), (1, "inner2"), (0, "inner3")):
                conv = feature._modules[inner]
                record(names[f"feature.{inner}"],
                       conv2d_nhwc(stems[skip], conv.weight, conv.bias))
            if not feature.dcn:
                for i, o in enumerate(outs):
                    record(names[f"feature.out{i + 1}"], o)

        handles.append(feature.register_forward_hook(topdown))
        if feature.dcn:
            for i in range(4):
                head = feature._modules[f"dcn{i + 1}"]
                if isinstance(head, NADCN):
                    handles.append(head.register_forward_pre_hook(
                        lambda m, a, i=i: record(names[f"feature.out{i + 1}"], a[0])))
    return handles


def _warp_views(model, outputs, imgs, proj_matrices, on: set, dump) -> None:
    """Bits 5 and 6: per stage and source view, the stage-resolution image
    warped onto the stage's hypotheses (K4 on the card) and its per-view
    weights through the port's correlation."""
    from ..core.geometry import relative_projection, resize_align_corners
    from ..ops.kernels.warp_fwd import warp_fwd
    from ..ops.warp_cor import correlate_view

    V = imgs.shape[1]
    for key in sorted(k for k in outputs if k.startswith("stage")):
        hypo = outputs[key]["hypo_depth"].float().contiguous()
        h, w = hypo.shape[-2:]
        projs = proj_matrices[key]
        stage_imgs = resize_align_corners(imgs.float(), (h, w))
        ref = stage_imgs[:, 0].contiguous()
        for v in range(1, V):
            src = stage_imgs[:, v].contiguous()
            rel = relative_projection(projs[:, v], projs[:, 0]).float().contiguous()
            if "5" in on:
                dump(f"{key}_warped_src{v - 1}", warp_fwd(src, rel, hypo)[0])
            if "6" in on:
                cor = correlate_view(src, ref, rel, hypo, group_cor=False, group_dim=1)
                wgt = torch.softmax(cor.sum(-1) / model.cfg.attn_temp, dim=1)
                dump(f"{key}_cor_weight_src{v - 1}", wgt[0] / math.sqrt(imgs.shape[-1]))


def debug_dump_forward(
    model,
    imgs: torch.Tensor,
    proj_matrices: Dict[str, torch.Tensor],
    depth_values: torch.Tensor,
    *,
    bits: int,
    outdir: str,
    train: bool = False,
    tag: str = "sample",
) -> Dict[str, str]:
    """Rerun one forward of ``model`` (train-mode with ``train``) on the
    inputs (tensors on the model's device) and write the intermediates of
    ``bits`` (module docstring). Returns ``{name: file path}``."""
    on = set(get_powers(bits))
    dump_dir = os.path.join(outdir, "debug")
    os.makedirs(dump_dir, exist_ok=True)
    written: Dict[str, str] = {}

    def dump(name: str, value) -> None:
        path = os.path.join(dump_dir, f"{tag}_{name}.npy")
        arr = value.detach().float().cpu().numpy() if isinstance(value, torch.Tensor) else value
        np.save(path, np.asarray(arr, np.float32))
        written[name] = path

    captured: Dict[str, torch.Tensor] = {}

    def record(flax_path: str, value: torch.Tensor) -> None:
        if value.dim() == 4:
            captured[flax_path] = value[0]

    was_training = model.training
    saved = {k: b.clone() for k, b in model.named_buffers()}
    handles = _capture_features(model, record) if "0" in on else []
    model.train(train)
    try:
        with torch.no_grad():
            outputs = model(imgs, proj_matrices, depth_values)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(saved[k])

    if "0" in on:
        dump("input_imgs", imgs[0])
        for flax_path in sorted(captured):
            dump(f"feat_{flax_path.replace('/', '.')}.__call__[0]", captured[flax_path])
    stages = sorted(k for k in outputs if k.startswith("stage"))
    for key in stages:
        st = outputs[key]
        if "1" in on:
            dump(f"{key}_depth", st["depth"][0])
        if "2" in on:
            dump(f"{key}_hypo_depth", st["hypo_depth"][0])
        if "3" in on:
            dump(f"{key}_attn_weight", st["attn_weight"][0])
        if "7" in on:
            dump(f"{key}_attn_logits", torch.log(st["attn_weight"][0].float() + 1e-12))
    if "4" in on:
        for key in stages:
            if "mono_depth" in outputs[key]:
                dump(f"{key}_mono_depth", outputs[key]["mono_depth"][0])
    if on & {"5", "6"}:
        with torch.no_grad():
            _warp_views(model, outputs, imgs, proj_matrices, on, dump)
    return written
