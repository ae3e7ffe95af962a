"""Typed configuration of the PyTorch port, and its device rule.

``ModelConfig`` and ``LossConfig`` keep the field names of the JAX
package's (``deep_reconstruction_with_epipolar_lines_mvster_tpu/config.py``),
so that ``ModelConfig(**dataclasses.asdict(jax_cfg))`` builds the same
model here.

The TPU execution-layout fields below are accepted and ignored: they choose
how the TPU lays out work, never the function the model computes. The port
does not branch on them; a tensor's device decides between a CUDA kernel
and its plain PyTorch version.

  pack_conv, warp_impl, warp_band, warp_tile_rows, warp_tile_cols,
  warp_xband, fused_topdown, fused_topdown_chain, fuse_warp_cor,
  kernel_coords, cw_stage_features, fuse_attn, d_pack_mids, remat

``remat`` (activation checkpointing) is among them: the DTU recipe trains
with ``--no_remat``, and the port keeps every activation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MVS4net architecture hyperparameters (reference: models/MVS4Net.py:16-67)."""

    arch_mode: str = "fpn"
    reg_mode: str = "reg2d"
    num_stages: int = 4
    fpn_base_channel: int = 8
    reg_channel: int = 8
    ndepths: Tuple[int, ...] = (8, 8, 4, 4)
    depth_inter_r: Tuple[float, ...] = (0.5, 0.5, 0.5, 1.0)
    group_cor: bool = False
    group_cor_dim: Tuple[int, ...] = (8, 8, 4, 4)
    inverse_depth: bool = False
    agg_type: str = "ConvBnReLU3D"
    dcn: bool = False
    pos_enc: int = 0
    mono: bool = False
    mono_stg_itrpl: str = "nearest"
    asff: bool = False
    attn_temp: float = 2.0
    attn_fuse_d: bool = True
    gn: bool = False
    dtype: str = "float32"
    # TPU execution-layout fields: accepted, ignored (module docstring)
    remat: bool = True
    warp_impl: str = "mxu_hybrid"
    warp_band: Any = 16
    warp_tile_rows: int = 8
    warp_xband: int = 192
    warp_tile_cols: int = 128
    pack_conv: bool = False
    fused_topdown: bool = False
    fused_topdown_chain: bool = True
    fuse_warp_cor: bool = True
    kernel_coords: bool = True
    cw_stage_features: bool = True
    fuse_attn: bool = False
    d_pack_mids: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    @property
    def fpn_out_channels(self) -> Tuple[int, ...]:
        b = self.fpn_base_channel
        return (8 * b, 4 * b, 2 * b, b)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """``mvs4net_loss`` weights (reference: models/MVS4Net.py:195-240): total
    ``= sum_s stage_lw[s] * (l1_lw * L1_mono + ot_lw * OT)``."""

    stage_lw: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    l1_lw: float = 0.0
    ot_lw: float = 1.0
    ot_iter: int = 3
    ot_eps: float = 1.0
    ot_continuous: bool = False
    inverse_depth: bool = False
    mono: bool = False


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means the card. Without CUDA this
    raises; running on the CPU has to be asked for (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
