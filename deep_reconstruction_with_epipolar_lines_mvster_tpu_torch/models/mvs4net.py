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

Row-sharded eval (``forward_steps`` with ``space_shards > 1``; JAX
``models/mvs4net.py:229-298``, the ``--space`` eval): the call computes rank
``space_rank`` of ``space_shards`` row windows. The pyramid runs whole (every source view's
features stay whole, so the warp needs no halo exchange); a stage whose
height ``h`` is a multiple of ``8 * space_shards`` and whose window
``h // space_shards + 2 * halo`` (``halo = space_halo`` rounded down to a
multiple of 8) is shorter than ``h`` runs on the window
``[start, start + ws)``, ``start = clip(rank * hs - halo, 0, h - ws)``: the
reference view's features and the hypotheses sliced to it, the reference
view's principal point moved up by ``start``; its outputs lose the halo and
the caller joins the ranks' rows back to full height.
The coarser stages run whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Generator, Optional, Tuple

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
        """The whole forward: ``forward_steps`` on one rank, which yields
        nothing."""
        steps = self.forward_steps(imgs, proj_matrices, depth_values)
        try:
            next(steps)
        except StopIteration as done:
            return done.value
        raise AssertionError("an unsharded forward yielded rows")

    def forward_steps(
        self,
        imgs: torch.Tensor,
        proj_matrices: Dict[str, torch.Tensor],
        depth_values: torch.Tensor,
        *,
        space_rank: int = 0,
        space_shards: int = 1,
        space_halo: int = 48,
    ) -> Generator[Dict[str, Tuple[torch.Tensor, int]], Dict[str, torch.Tensor], Dict]:
        """The forward as a generator, rank ``space_rank`` of
        ``space_shards`` (module docstring): at each row-windowed stage it
        yields ``{output: (this rank's rows without the halo, row axis)}``
        and takes back ``{output: the rows of every rank, joined}`` from its
        caller (``parallel.mesh.sharded_eval_forward``); it returns the
        outputs. Without a windowed stage it yields nothing."""
        cfg = self.cfg
        train = self.training
        if space_shards > 1 and train:
            raise ValueError("the row-sharded forward is an eval path")
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
            projs = proj_matrices[f"stage{s + 1}"]
            window = _row_window(h, space_rank, space_shards, space_halo)
            if window is not None:
                start, ws, crop, hs = window
                hypo = hypo[:, :, start:start + ws].contiguous()
                views = [views[0][:, start:start + ws].contiguous()] + views[1:]
                # window-local reference rows: the reference camera's
                # principal point moves up by the window start
                projs = projs.clone()
                projs[:, 0, 1, 1, 2] -= start
            out = run_stage(
                views, projs, hypo, self._regnet(s, hypo),
                group_cor=cfg.group_cor,
                group_dim=cfg.group_cor_dim[s],
                split_itv=cfg.depth_inter_r[s],
                attn_temp=cfg.attn_temp,
                attn_fuse_d=cfg.attn_fuse_d,
                inverse_depth=cfg.inverse_depth,
                train=train,
            )
            if window is not None:
                # no mono_feat: views[0] is a window, and eval never reads it
                rows = {k: _own_rows(v, crop, hs) for k, v in out.items() if v.dim() >= 3}
                out = {**out, **(yield rows)}
            elif cfg.mono:
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


def _row_window(h: int, rank: int, shards: int, halo: int) -> Optional[Tuple[int, int, int, int]]:
    """``(start, ws, crop, hs)`` of rank ``rank``'s row window of a stage of
    height ``h``, or None where the stage runs whole (one shard, a height
    that the shards' 8-row blocks do not divide, or a window no shorter
    than the stage)."""
    if shards <= 1:
        return None
    halo -= halo % 8
    hs = h // shards
    ws = hs + 2 * halo
    if h % (8 * shards) or ws >= h:
        return None
    start = min(max(rank * hs - halo, 0), h - ws)
    return start, ws, rank * hs - start, hs


def _own_rows(v: torch.Tensor, crop: int, hs: int) -> Tuple[torch.Tensor, int]:
    """A windowed stage output's own rows, without the halo, and its row
    axis: 2 of ``[B, D, ws, w]``, 1 of ``[B, ws, w]``."""
    axis = 2 if v.dim() == 4 else 1
    return v.narrow(axis, crop, hs).contiguous(), axis
