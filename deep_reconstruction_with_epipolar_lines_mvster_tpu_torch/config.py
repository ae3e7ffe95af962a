"""Typed configuration of the PyTorch port, and its device rule.

``ModelConfig``, ``LossConfig`` and ``TrainConfig`` keep the field names of
the JAX package's (``deep_reconstruction_with_epipolar_lines_mvster_tpu/config.py``),
so that ``ModelConfig(**dataclasses.asdict(jax_cfg))`` builds the same
model here; ``parse_*`` are copies of its parsers of the reference's string
encodings (``--ndepths "8,8,4,4"``, ``--lrepochs "6,8,9:2"``, ``--Nlights
"3:7"``).

The TPU execution-layout fields below are accepted and ignored: they choose
how the TPU lays out work, never the function the model computes. The port
does not branch on them; a tensor's device decides between a CUDA kernel
and its plain PyTorch version.

  pack_conv, warp_impl, warp_band, warp_tile_rows, warp_tile_cols,
  warp_xband, fused_topdown, fused_topdown_chain, fuse_warp_cor,
  kernel_coords, cw_stage_features, fuse_attn, d_pack_mids, remat

``remat`` (activation checkpointing) is among them: the DTU recipe trains
with ``--no_remat``, and the port keeps every activation.

What the functions these flags name run as on the card, whatever the flags
say (on the CPU, each kernel's plain PyTorch version):

- ``fused_topdown`` / ``fused_topdown_chain``: the FPN top-down levels are
  kernel K2 (``csrc/topdown.cu``), in training also in the chain's
  backward;
- ``fuse_warp_cor`` / ``kernel_coords`` / ``warp_impl``: the eval warp +
  group correlation is K1 (``csrc/warp_cor.cu``, coordinates in-kernel);
  the plain warp forward, of the train path and of the eval
  squared-difference branch, is K4 (``csrc/warp_fwd.cu``); the warp's
  backward is K3 (``csrc/warp_bwd.cu``); every one an exact gather, so
  ``warp_band``, ``warp_xband`` and the tile sizes bound nothing;
- ``fuse_attn``: the eval attention accumulation with ``attn_fuse_d`` and
  group correlation is K5 (``csrc/attn_fuse.cu``); the train path and the
  ``attn_fuse_d=False`` form stay PyTorch, as the JAX kernel covers
  neither;
- ``pack_conv``: the small-channel convolutions it packs on the TPU run,
  in eval, as kernel K6 (``csrc/band_conv.cu``: 3x3 stride-1 conv with the
  BatchNorm folded and the ReLU fused, at most 64 channels in and out in
  bf16 and 32 in float32, ``models/layers.py``); every other convolution,
  and every one in training, is cuDNN's;
- ``cw_stage_features``, ``d_pack_mids``: layouts only.

The train CLI (``cli/train.py``) accepts and ignores the flags that set
them, and two more of the same kind: ``--warp_bwd`` (which TPU
warp-backward variant; the port's is K3) and ``--no_remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_int_list(s: str) -> Tuple[int, ...]:
    """``"8,8,4,4" -> (8, 8, 4, 4)`` (reference: train_mvs4.py:510)."""
    return tuple(int(x) for x in s.split(",") if x)


def parse_float_list(s: str) -> Tuple[float, ...]:
    """``"0.5,0.5,0.5,1" -> (0.5, 0.5, 0.5, 1.0)`` (train_mvs4.py:511)."""
    return tuple(float(x) for x in s.split(",") if x)


def parse_lrepochs(s: str) -> Tuple[Tuple[int, ...], float]:
    """``"6,8,9:2" -> ((6, 8, 9), 2.0)``: milestone epochs and LR divisor
    (reference: train_mvs4.py:120-121)."""
    milestones, divisor = s.split(":")
    return parse_int_list(milestones), float(divisor)


def parse_nlights(s: str) -> Tuple[int, int]:
    """``"3:7" -> (3, 7)``: use 3 of 7 lights; a negative first element
    means a fixed light index (reference: datasets/blender4.py:25-27,52-66)."""
    use, total = s.split(":")
    return int(use), int(total)


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop settings (reference:
    train_mvs4.py:33-52,118-137)."""

    lr: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 10
    batch_size: int = 1
    lr_scheduler: str = "MS"            # MS | cos | onecycle | CyclicLR_tri2 | exponent
    lr_milestones: Tuple[int, ...] = (6, 8, 9)   # epochs
    lr_gamma_divisor: float = 2.0
    warmup_iters: int = 500
    warmup_factor: float = 1.0 / 3.0
    seed: int = 1
    summary_freq: int = 50
    save_freq: int = 1
    eval_freq: int = 1


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


def setup_device(device=None) -> torch.device:
    """What an entry point calls before it builds a model: the device of
    ``resolve_device(device)`` and the port's precision policy, which turns
    TF32 off for cuDNN convolutions and for matmuls (PyTorch lets cuDNN
    convolutions run in TF32 by default), so that a float32 configuration
    computes in float32 on the card as on the CPU. bf16 work is not
    affected. The flags are process-wide."""
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
