"""MVS4Net, the 4-stage cascaded MVSTER network: eval and train forward.

Counterpart of the JAX package's ``models/mvs4net.py`` (reference
``models/MVS4Net.py:16-193``) for ``arch_mode="fpn"``, ``reg_mode="reg2d"``
with ``ConvBnReLU3D`` mid blocks, and no asff/dcn/pos-enc/GroupNorm. The
FPN runs once over all views folded into the batch; stages are unrolled.

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
from .fpn import FPN4
from .layers import ConvWeight
from .mono import MonoDepthDecoder
from .reg import Reg2D
from .stagenet import run_stage


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "arch_mode": cfg.arch_mode != "fpn",
        "reg_mode": cfg.reg_mode != "reg2d",
        "agg_type": cfg.agg_type != "ConvBnReLU3D",
        "dcn": cfg.dcn,
        "asff": cfg.asff,
        "pos_enc": cfg.pos_enc != 0,
        "gn": cfg.gn,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"MVS4Net port: unsupported config fields {bad}")


class MVS4Net(nn.Module):
    """The network, in eval mode when built. ``device`` defaults to the
    card and raises without CUDA unless ``device="cpu"`` is given; weights
    are drawn from ``generator`` (seed 0 when none is given)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.feature = FPN4(cfg.fpn_base_channel)
        in_ch = cfg.group_cor_dim if cfg.group_cor else cfg.fpn_out_channels
        self.reg = nn.ModuleList(
            Reg2D(in_ch[s], cfg.reg_channel, cfg.ndepths[s])
            for s in range(cfg.num_stages)
        )
        if cfg.mono:
            self.mono_depth_decoder = MonoDepthDecoder(
                cfg.fpn_out_channels[: cfg.num_stages], cfg.mono_stg_itrpl
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, ConvWeight):
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
        feats = [p.reshape(B, V, *p.shape[1:])
                 for p in self.feature(folded, view_groups=V)]
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
            out = run_stage(
                views, proj_matrices[f"stage{s + 1}"], hypo.float(), self.reg[s],
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
