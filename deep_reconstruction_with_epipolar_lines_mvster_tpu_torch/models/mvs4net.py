"""MVS4Net, the 4-stage cascaded MVSTER network: eval and train forward.

Counterpart of the JAX package's ``models/mvs4net.py`` (reference
``models/MVS4Net.py:16-193``), with every variant it builds:

- ``arch_mode``: ``fpn`` (``FPN4``), ``fpn_convnext`` or ``fpn_convnext4``
  (``FPN4ConvNeXt``); any other raises ``ValueError``;
- ``gn``: GroupNorm in the pyramid's stem and DCN heads; ``dcn``: the
  deformable-conv heads on the pyramid's outputs;
- ``asff``: each stage's features fused from all four levels (``ASFF``);
- ``reg_mode``: ``reg2d`` (``Reg2D``, its mid blocks by ``agg_type``, an
  unknown one raising ``KeyError``), anything else ``Reg3D``;
- ``pos_enc``: 1 (sine) or 2 (learned) adds an encoding of the stage's
  hypotheses to its cost volume before the regularizer, as the JAX package
  does (the reference parses the flag and drops it).

The pyramid, and ASFF, run once over all views folded into the batch;
stages are unrolled.

Inputs (the reference sample spec, as tensors on the model's device):
  imgs            [B, V, H, W, 3]
  proj_matrices   {"stage1".."stage4": [B, V, 2, 4, 4]}
  depth_values    [B, >=2]  (min..max)

Output: {"stage{i}": {depth, photometric_confidence, hypo_depth,
attn_weight, inverse_min_depth*, inverse_max_depth*, mono_feat*,
mono_depth* (train, stages 2-4)}}.

``model.train()`` selects the train forward, as ``train=True`` does in the
JAX package: train-mode BatchNorm (per view in the FPN stem), a zero
photometric confidence, and with ``mono`` the mono depth decoder. The
next stage's depth window comes from detached predictions either way.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import ModelConfig, resolve_device
from ..core.hypothesis import (
    init_inverse_range,
    init_range,
    schedule_inverse_range,
    schedule_range,
)
from .fpn import ASFF, FPN4, FPN4ConvNeXt
from .layers import ConvWeight
from .mono import MonoDepthDecoder
from .posenc import PosEncLearned, PosEncSine
from .reg import REG3D_DOWN_SIZE, Reg2D, Reg3D
from .stagenet import run_stage


def _backbone(cfg: ModelConfig) -> nn.Module:
    b, gn, dcn = cfg.fpn_base_channel, cfg.gn, cfg.dcn
    if cfg.arch_mode == "fpn":
        return FPN4(b, gn, dcn)
    if cfg.arch_mode in ("fpn_convnext", "fpn_convnext4"):
        return FPN4ConvNeXt(b, gn, dcn, patchify=cfg.arch_mode == "fpn_convnext4")
    raise ValueError(f"unknown arch_mode {cfg.arch_mode!r}")


class MVS4Net(nn.Module):
    """The network, in eval mode when built. ``device`` defaults to the
    card and raises without CUDA unless ``device="cpu"`` is given; weights
    are drawn from ``generator`` (seed 0 when none is given)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.feature = _backbone(cfg)
        stages = range(cfg.num_stages)
        if cfg.asff:
            self.asff = nn.ModuleList(ASFF(s, cfg.fpn_base_channel) for s in stages)
        in_ch = cfg.group_cor_dim if cfg.group_cor else cfg.fpn_out_channels
        if cfg.reg_mode == "reg2d":
            self.reg = nn.ModuleList(
                Reg2D(in_ch[s], cfg.reg_channel, cfg.ndepths[s], cfg.agg_type) for s in stages)
        else:
            self.reg = nn.ModuleList(
                Reg3D(in_ch[s], cfg.reg_channel, REG3D_DOWN_SIZE[s], cfg.ndepths[s])
                for s in stages)
        if cfg.pos_enc == 1:
            self.pos_enc = nn.ModuleList(PosEncSine() for _ in stages)
        elif cfg.pos_enc == 2:
            self.pos_enc = nn.ModuleList(PosEncLearned(cfg.ndepths[s], in_ch[s]) for s in stages)
        else:
            self.pos_enc = None
        if cfg.mono:
            self.mono_depth_decoder = MonoDepthDecoder(
                cfg.fpn_out_channels[: cfg.num_stages], cfg.mono_stg_itrpl
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (ConvWeight, PosEncLearned)):
                m.reset_parameters(generator)
        self.eval()
        self.to(dev)

    def forward(
        self,
        imgs: torch.Tensor,
        proj_matrices: Dict[str, torch.Tensor],
        depth_values: torch.Tensor,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        train = self.training
        B, V, H, W, _ = imgs.shape
        folded = imgs.to(cfg.torch_dtype).reshape(B * V, H, W, imgs.shape[-1])
        feats = self.feature(folded, view_groups=V)
        if cfg.asff:
            feats = [fuse(feats, view_groups=V) for fuse in self.asff]
        feats = [p.reshape(B, V, *p.shape[1:]) for p in feats]
        depth_interval = (depth_values[:, -1] - depth_values[:, 0]) / depth_values.shape[1]

        outputs: Dict[str, Dict[str, torch.Tensor]] = {}
        prev: Dict[str, torch.Tensor] = {}
        for s in range(cfg.num_stages):
            views = [feats[s][:, v] for v in range(V)]
            h, w = views[0].shape[1:3]
            if s == 0:
                init = init_inverse_range if cfg.inverse_depth else init_range
                hypo = init(depth_values, cfg.ndepths[0], h, w)
            elif cfg.inverse_depth:
                hypo = schedule_inverse_range(
                    prev["inverse_min_depth"], prev["inverse_max_depth"],
                    cfg.ndepths[s], h, w,
                )
            else:
                hypo = schedule_range(
                    prev["depth"], cfg.ndepths[s],
                    cfg.depth_inter_r[s] * depth_interval, h, w,
                )
            hypo = hypo.float()
            out = run_stage(
                views, proj_matrices[f"stage{s + 1}"], hypo, self._regnet(s, hypo),
                group_cor=cfg.group_cor,
                group_dim=cfg.group_cor_dim[s],
                split_itv=cfg.depth_inter_r[s],
                attn_temp=cfg.attn_temp,
                attn_fuse_d=cfg.attn_fuse_d,
                inverse_depth=cfg.inverse_depth,
                train=train,
            )
            if cfg.mono:
                out["mono_feat"] = views[0]
            outputs[f"stage{s + 1}"] = out
            # next-stage windows come from detached predictions
            # (reference MVS4Net.py:116-118)
            prev = {k: out[k].detach() for k in
                    ("depth", "inverse_min_depth", "inverse_max_depth") if k in out}

        if cfg.mono and train:
            mono_depths = self.mono_depth_decoder(
                [outputs[f"stage{s + 1}"]["mono_feat"] for s in range(cfg.num_stages)],
                depth_values[:, 0], depth_values[:, 1],
            )
            for i, md in enumerate(mono_depths):
                outputs[f"stage{i + 2}"]["mono_depth"] = md
        return outputs

    def _regnet(self, s: int, hypo: torch.Tensor):
        """Stage ``s``'s regularizer on the folded volume ``[B*D, h, w, C]``,
        after the positional encoding of ``hypo [B, D, h, w]`` where the
        configuration has one."""
        if self.pos_enc is None:
            return self.reg[s]

        def regnet(vol):
            B, D, h, w = hypo.shape
            vol = self.pos_enc[s](vol.reshape(B, D, h, w, -1), hypo).reshape(vol.shape)
            return self.reg[s](vol)

        return regnet
