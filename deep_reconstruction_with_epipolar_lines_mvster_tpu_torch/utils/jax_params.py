"""The JAX package's ``variables`` (and gradients) -> the port's names.

Turns the flax ``{"params", "batch_stats"}`` tree of the JAX ``MVS4Net``
(numpy arrays) into the reference torch ``state_dict`` that the port's
modules are named after. The key and layout tables are a copy of the JAX
package's ``utils/torch_port.py`` (its reference -> flax transplant), run in
reverse, for every variant the configuration names: FPN4 or the ConvNeXt
pyramids, with BatchNorm or GroupNorm, with or without the DCN heads;
ASFF; reg2d with any ``agg_type`` or reg3d; the learned positional
encoding; and the mono depth decoder where the tree has one (flax creates
it only in a train-mode init).

The reference has no key for the learned positional encoding (its
``--pos_enc`` is a dead flag): the port names it ``pos_enc.{s}.depth_embed``,
from flax's ``pos_enc_stage{s+1}/depth_embed``.

Every transform is a permutation of the array, so the same table carries a
flax-shaped gradient tree to the port's parameter names
(``jax_grads_to_port``).

  flax Conv          [kh, kw, I, O]      -> [O, I, kh, kw]
  flax Conv 3-D      [kd, kh, kw, I, O]  -> [O, I, kd, kh, kw]
  folded (1,k,k)     [kh, kw, I, O]      -> [O, I, 1, kh, kw]
  ConvTranspose      [kh, kw, I, O]      -> spatial flip, [I, O, 1, kh, kw]
  ConvTranspose 3-D  [kd, kh, kw, I, O]  -> spatial flip, [I, O, kd, kh, kw]
  Dense              [I, O]              -> [O, I]
  DCN tap contraction [1, 1, 9*I, O]     -> [O, I, 3, 3]
  BatchNorm          scale/bias, mean/var -> weight/bias, running_mean/var
  GroupNorm, LayerNorm scale/bias        -> weight/bias
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig

# ------------------------------------------------------------- transforms ---


def _conv2d(k) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _conv3d(k) -> np.ndarray:
    return np.transpose(k, (4, 3, 0, 1, 2))


def _conv3d_as_2d(k) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))[:, :, None]


def _deconv3d_as_2d(k) -> np.ndarray:
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1][:, :, None]


def _deconv3d(k) -> np.ndarray:
    return np.transpose(k, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]


def _dense(k) -> np.ndarray:
    return np.transpose(k, (1, 0))


def _dcn_weight(k) -> np.ndarray:
    n, O = k.shape[2:]
    return np.transpose(k.reshape(3, 3, n // 9, O), (3, 2, 0, 1))


def _vec(v) -> np.ndarray:
    return v


# ------------------------------------------------------------- key tables ---


def _bn(entries, flax_prefix: str, torch_prefix: str):
    entries.append(("params", f"{flax_prefix}/scale", f"{torch_prefix}.weight", _vec))
    entries.append(("params", f"{flax_prefix}/bias", f"{torch_prefix}.bias", _vec))
    entries.append(
        ("batch_stats", f"{flax_prefix}/mean", f"{torch_prefix}.running_mean", _vec)
    )
    entries.append(
        ("batch_stats", f"{flax_prefix}/var", f"{torch_prefix}.running_var", _vec)
    )


def _conv_bn_relu(entries, flax_prefix: str, torch_prefix: str, transform=_conv2d,
                  gn: bool = False):
    entries.append(
        ("params", f"{flax_prefix}/Conv_0/kernel", f"{torch_prefix}.conv.weight", transform)
    )
    if gn:
        entries.append(
            ("params", f"{flax_prefix}/Conv_0/bias", f"{torch_prefix}.conv.bias", _vec))
        _affine(entries, f"{flax_prefix}/GroupNorm_0", f"{torch_prefix}.gn")
    else:
        _bn(entries, f"{flax_prefix}/BatchNorm_0", f"{torch_prefix}.bn")


def _affine(entries, flax_prefix: str, torch_prefix: str):
    entries.append(("params", f"{flax_prefix}/scale", f"{torch_prefix}.weight", _vec))
    entries.append(("params", f"{flax_prefix}/bias", f"{torch_prefix}.bias", _vec))


def _param(entries, flax_path: str, torch_key: str, transform, bias: bool = True):
    """A kernel (and its bias) of one flax module."""
    entries.append(("params", f"{flax_path}/kernel", f"{torch_key}.weight", transform))
    if bias:
        entries.append(("params", f"{flax_path}/bias", f"{torch_key}.bias", _vec))


def _topdown_entries(entries, td: str, dcn: bool = False, gn: bool = False):
    for i, p in enumerate(["inner1", "inner2", "inner3"]):
        _param(entries, f"{td}/Conv_{i}", f"feature.{p}", _conv2d)
    for i, p in enumerate(["out1", "out2", "out3", "out4"]):
        _param(entries, f"{td}/Conv_{i + 3}", f"feature.{p}", _conv2d, bias=False)
    if dcn:
        for i in range(4):
            _nadcn_entries(entries, f"{td}/NADCN_{i}", f"feature.dcn{i + 1}", gn)


def _nadcn_entries(entries, na: str, t: str, gn: bool):
    if gn:
        _affine(entries, f"{na}/GroupNorm_0", f"{t}.0")
    else:
        _bn(entries, f"{na}/BatchNorm_0", f"{t}.0")
    _dcn_entries(entries, f"{na}/DeformConv2d_0", f"{t}.2")


def _dcn_entries(entries, dc: str, t: str):
    _param(entries, f"{dc}/Conv_0", f"{t}.conv_offset", _conv2d)
    _param(entries, f"{dc}/Conv_1", t, _dcn_weight, bias=False)


def _fpn4_entries(entries, feature: str, dcn: bool = False, gn: bool = False):
    stem = [
        "conv0.0", "conv0.1",
        "conv1.0", "conv1.1", "conv1.2",
        "conv2.0", "conv2.1", "conv2.2",
        "conv3.0", "conv3.1", "conv3.2",
    ]
    for i, p in enumerate(stem):
        _conv_bn_relu(entries, f"{feature}/ConvBnReLU_{i}", f"feature.{p}", gn=gn)
    _topdown_entries(entries, f"{feature}/_TopDown_0", dcn, gn)


def _fpn4_convnext_entries(entries, feature: str, patchify: bool, dcn: bool = False,
                           gn: bool = False):
    for i in range(2):
        _conv_bn_relu(entries, f"{feature}/ConvBnReLU_{i}", f"feature.conv0.{i}", gn=gn)
    block_cls = "ConvNeXt4Block" if patchify else "ConvNeXtBlock"
    for i in range(3):
        _convnext_block_entries(entries, f"{feature}/{block_cls}_{i}", f"feature.conv{i + 1}",
                                patchify)
    _topdown_entries(entries, f"{feature}/_TopDown_0", dcn, gn)


def _convnext_block_entries(entries, blk: str, tb: str, patchify: bool):
    convs = ["sconv", "dwconv"] if patchify else ["dwconv"]
    for j, name in enumerate(convs):
        _param(entries, f"{blk}/Conv_{j}", f"{tb}.{name}", _conv2d)
    _affine(entries, f"{blk}/LayerNorm_0", f"{tb}.norm")
    _param(entries, f"{blk}/Dense_0", f"{tb}.pwconv1", _dense)
    _param(entries, f"{blk}/Dense_1", f"{tb}.pwconv2", _dense)
    entries.append(("params", f"{blk}/gamma", f"{tb}.gamma", _vec))


# per ASFF level, its three level convs in flax's instantiation order
_ASFF_LEVEL_CONVS = {
    0: ["stride_level_1", "stride_level_2", "stride_level_3"],
    1: ["compress_level_0", "stride_level_2", "stride_level_3"],
    2: ["compress_level_0", "compress_level_1", "stride_level_3"],
    3: ["compress_level_0", "compress_level_1", "compress_level_2"],
}


def _asff_entries(entries, num_stages: int):
    for s in range(num_stages):
        _asff_level_entries(entries, f"ASFF_{s}", f"asff.{s}", s)


def _asff_level_entries(entries, f: str, t: str, level: int):
    for i, name in enumerate(_ASFF_LEVEL_CONVS[level]):
        _conv_bn_relu(entries, f"{f}/ConvBnReLU_{i}", f"{t}.{name}")
    for k in range(4):
        _conv_bn_relu(entries, f"{f}/ConvBnReLU_{3 + k}", f"{t}.weight_level_{k}")
    _param(entries, f"{f}/Conv_0", f"{t}.weight_levels", _conv2d)
    _conv_bn_relu(entries, f"{f}/ConvBnReLU_7", f"{t}.expand")


def _agg_block(entries, flax_blk: str, torch_blk: str, agg_type: str):
    _conv_bn_relu(entries, flax_blk, torch_blk, _conv3d)
    if agg_type in ("ConvBnReLU3D_CAM", "ConvBnReLU3D_DCAM"):
        for j, t in enumerate(("linear_agg.0", "linear_agg.2")):
            _param(entries, f"{flax_blk}/_MLP_0/Dense_{j}", f"{torch_blk}.{t}", _dense)
    elif agg_type == "ConvBnReLU3D_PAM":
        _param(entries, f"{flax_blk}/Conv_1", f"{torch_blk}.pixel_conv", _conv2d)
    else:
        _param(entries, f"{flax_blk}/Conv_1", f"{torch_blk}.spatial_conv", _conv3d)


def _reg2d_entries(entries, flax_reg: str, torch_reg: str, agg_type: str = "ConvBnReLU3D"):
    # flax numbers children in instantiation order: each mid block is
    # constructed before the stride conv it wraps; an attention mid block
    # has a class counter of its own
    if agg_type == "ConvBnReLU3D":
        order = [
            ("ConvBnReLU3D_0", "conv0", _conv3d_as_2d),
            ("ConvBnReLU3D_1", "conv2", _conv3d),
            ("ConvBnReLU3D_2", "conv1", _conv3d_as_2d),
            ("ConvBnReLU3D_3", "conv4", _conv3d),
            ("ConvBnReLU3D_4", "conv3", _conv3d_as_2d),
            ("ConvBnReLU3D_5", "conv6", _conv3d),
            ("ConvBnReLU3D_6", "conv5", _conv3d_as_2d),
        ]
    else:
        order = [
            ("ConvBnReLU3D_0", "conv0", _conv3d_as_2d),
            ("ConvBnReLU3D_1", "conv1", _conv3d_as_2d),
            ("ConvBnReLU3D_2", "conv3", _conv3d_as_2d),
            ("ConvBnReLU3D_3", "conv5", _conv3d_as_2d),
        ]
        for i, torch_name in enumerate(["conv2", "conv4", "conv6"]):
            _agg_block(entries, f"{flax_reg}/{agg_type}_{i}", f"{torch_reg}.{torch_name}",
                       agg_type)
    for flax_name, torch_name, tr in order:
        _conv_bn_relu(entries, f"{flax_reg}/{flax_name}", f"{torch_reg}.{torch_name}", tr)
    for i, torch_name in enumerate(["conv7", "conv9", "conv11"]):
        entries.append((
            "params",
            f"{flax_reg}/DeconvBnReLU3D_{i}/ConvTranspose_0/kernel",
            f"{torch_reg}.{torch_name}.0.weight",
            _deconv3d_as_2d,
        ))
        _bn(entries, f"{flax_reg}/DeconvBnReLU3D_{i}/BatchNorm_0", f"{torch_reg}.{torch_name}.1")
    _param(entries, f"{flax_reg}/Conv_0", f"{torch_reg}.prob", _conv3d_as_2d)


def _reg3d_entries(entries, flax_reg: str, torch_reg: str, down_size: int):
    # flax builds the _C3 blocks in call order, the outer (stride-1) block
    # of each level before the inner (stride-2) one it wraps
    order = ["conv0", "conv2", "conv1", "conv4", "conv3", "conv6", "conv5"][: 2 * down_size + 1]
    for i, torch_name in enumerate(order):
        _conv_bn_relu(entries, f"{flax_reg}/_C3_{i}", f"{torch_reg}.{torch_name}", _conv3d)
    for i, torch_name in enumerate(["conv7", "conv9", "conv11"][3 - down_size:]):
        tr = f"{flax_reg}/DeconvBnReLU3D_true_{i}"
        entries.append(("params", f"{tr}/ConvTranspose_0/kernel",
                        f"{torch_reg}.{torch_name}.0.weight", _deconv3d))
        _bn(entries, f"{tr}/BatchNorm_0", f"{torch_reg}.{torch_name}.1")
    _param(entries, f"{flax_reg}/Conv_0", f"{torch_reg}.prob", _conv3d, bias=False)


def _mono_entries(entries):
    for i in range(3):
        _conv_bn_relu(entries, f"MonoDepthDecoder_0/ConvBnReLU_{i}",
                      f"mono_depth_decoder.convblocks.{i}")
        entries.append(("params", f"MonoDepthDecoder_0/Conv_{i}/kernel",
                        f"mono_depth_decoder.conv3x3.{i}.weight", _conv2d))
        entries.append(("params", f"MonoDepthDecoder_0/Conv_{i}/bias",
                        f"mono_depth_decoder.conv3x3.{i}.bias", _vec))


# ------------------------------------------------------------------ public --


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def _entries(flat_params, cfg: ModelConfig, num_stages: int) -> list:
    from ..models.reg import REG3D_DOWN_SIZE

    feature = next(
        p.split("/")[0] for p in flat_params if "FPN4" in p.split("/")[0]
    )
    entries: list = []
    if cfg.arch_mode == "fpn":
        _fpn4_entries(entries, feature, cfg.dcn, cfg.gn)
    else:
        _fpn4_convnext_entries(entries, feature, cfg.arch_mode == "fpn_convnext4",
                               cfg.dcn, cfg.gn)
    if cfg.asff:
        _asff_entries(entries, num_stages)
    for s in range(num_stages):
        if cfg.reg_mode == "reg2d":
            _reg2d_entries(entries, f"reg_stage{s + 1}", f"reg.{s}", cfg.agg_type)
        else:
            _reg3d_entries(entries, f"reg_stage{s + 1}", f"reg.{s}", REG3D_DOWN_SIZE[s])
        if cfg.pos_enc == 2:
            entries.append(("params", f"pos_enc_stage{s + 1}/depth_embed",
                            f"pos_enc.{s}.depth_embed", _vec))
    if any(p.startswith("MonoDepthDecoder_0/") for p in flat_params):
        _mono_entries(entries)
    return entries


def jax_variables_to_state_dict(variables, num_stages: Optional[int] = None,
                                cfg: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """Convert JAX ``MVS4Net`` variables (``{"params", "batch_stats"}``, numpy
    or JAX arrays) into a ``state_dict`` for the port's ``MVS4Net`` built
    with ``cfg`` (by default the flagship's variant fields: FPN4, reg2d,
    BatchNorm) and its ``num_stages`` (by default ``cfg.num_stages``).

    Raises ``ValueError`` listing every leaf of the JAX tree that no table
    entry covers, so a partial conversion cannot pass silently."""
    cfg = cfg or ModelConfig()
    flat_params = _flatten(variables["params"])
    n = cfg.num_stages if num_stages is None else num_stages
    return entries_to_state_dict(_entries(flat_params, cfg, n), variables)


def entries_to_state_dict(entries, variables) -> Dict[str, torch.Tensor]:
    """Apply a key table (``(collection, flax path, torch key, transform)``
    entries) to ``variables``; raises ``ValueError`` listing every leaf the
    table misses or the tree lacks."""
    flat = {col: _flatten(variables.get(col, {})) for col in ("params", "batch_stats")}
    sd: Dict[str, torch.Tensor] = {}
    problems = []
    used = {col: set() for col in flat}
    for col, flax_path, torch_key, transform in entries:
        leaf = flat[col].get(flax_path)
        if leaf is None:
            problems.append(f"no flax leaf {col}:{flax_path} (for {torch_key})")
            continue
        used[col].add(flax_path)
        arr = transform(np.asarray(leaf, dtype=np.float32))
        sd[torch_key] = torch.tensor(np.ascontiguousarray(arr))
        if torch_key.endswith(".running_mean"):
            sd[torch_key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    for col in flat:
        for path in sorted(set(flat[col]) - used[col]):
            problems.append(f"flax leaf not covered: {col}:{path}")
    if problems:
        raise ValueError("flax -> port conversion incomplete:\n  " + "\n  ".join(problems))
    return sd


def jax_grads_to_port(grads, num_stages: Optional[int] = None,
                      cfg: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """A flax-shaped gradient tree (``jax.grad`` with respect to
    ``variables["params"]``) of the model of ``cfg`` -> ``{port parameter
    name: gradient}`` in the port's layouts. Raises ``ValueError`` on a leaf
    no entry covers."""
    cfg = cfg or ModelConfig()
    flat = _flatten(grads)
    out: Dict[str, torch.Tensor] = {}
    n = cfg.num_stages if num_stages is None else num_stages
    for col, flax_path, torch_key, transform in _entries(flat, cfg, n):
        if col == "params" and flax_path in flat:
            arr = transform(np.asarray(flat.pop(flax_path), dtype=np.float32))
            out[torch_key] = torch.tensor(np.ascontiguousarray(arr))
    if flat:
        raise ValueError(f"flax gradient leaves not covered: {sorted(flat)}")
    return out
