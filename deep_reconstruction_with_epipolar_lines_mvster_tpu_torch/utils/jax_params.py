"""The JAX package's ``variables`` (and gradients) -> the port's names.

Turns the flax ``{"params", "batch_stats"}`` tree of the JAX ``MVS4Net``
(numpy arrays) into the reference torch ``state_dict`` that the port's
modules are named after. The key and layout tables are a copy of the JAX
package's ``utils/torch_port.py`` (its reference -> flax transplant), run in
reverse and kept to what the port's model holds: FPN4 with BatchNorm, reg2d
with ``ConvBnReLU3D`` mid blocks, and the mono depth decoder where the tree
has one (flax creates it only in a train-mode init).

Every transform is a permutation of the array, so the same table carries a
flax-shaped gradient tree to the port's parameter names
(``jax_grads_to_port``).

  flax Conv          [kh, kw, I, O]      -> [O, I, kh, kw]
  flax Conv 3-D      [kd, kh, kw, I, O]  -> [O, I, kd, kh, kw]
  folded (1,k,k)     [kh, kw, I, O]      -> [O, I, 1, kh, kw]
  ConvTranspose      [kh, kw, I, O]      -> spatial flip, [I, O, 1, kh, kw]
  BatchNorm          scale/bias, mean/var -> weight/bias, running_mean/var
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# ------------------------------------------------------------- transforms ---


def _conv2d(k) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _conv3d(k) -> np.ndarray:
    return np.transpose(k, (4, 3, 0, 1, 2))


def _conv3d_as_2d(k) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))[:, :, None]


def _deconv3d_as_2d(k) -> np.ndarray:
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1][:, :, None]


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


def _conv_bn_relu(entries, flax_prefix: str, torch_prefix: str, transform=_conv2d):
    entries.append(
        ("params", f"{flax_prefix}/Conv_0/kernel", f"{torch_prefix}.conv.weight", transform)
    )
    _bn(entries, f"{flax_prefix}/BatchNorm_0", f"{torch_prefix}.bn")


def _topdown_entries(entries, td: str):
    for i, p in enumerate(["inner1", "inner2", "inner3"]):
        entries.append(("params", f"{td}/Conv_{i}/kernel", f"feature.{p}.weight", _conv2d))
        entries.append(("params", f"{td}/Conv_{i}/bias", f"feature.{p}.bias", _vec))
    for i, p in enumerate(["out1", "out2", "out3", "out4"]):
        entries.append(
            ("params", f"{td}/Conv_{i + 3}/kernel", f"feature.{p}.weight", _conv2d)
        )


def _fpn4_entries(entries, feature: str):
    stem = [
        "conv0.0", "conv0.1",
        "conv1.0", "conv1.1", "conv1.2",
        "conv2.0", "conv2.1", "conv2.2",
        "conv3.0", "conv3.1", "conv3.2",
    ]
    for i, p in enumerate(stem):
        _conv_bn_relu(entries, f"{feature}/ConvBnReLU_{i}", f"feature.{p}")
    _topdown_entries(entries, f"{feature}/_TopDown_0")


def _reg2d_entries(entries, flax_reg: str, torch_reg: str):
    # flax numbers children in instantiation order: each mid block is
    # constructed before the stride conv it wraps
    order = [
        ("ConvBnReLU3D_0", "conv0", _conv3d_as_2d),
        ("ConvBnReLU3D_1", "conv2", _conv3d),
        ("ConvBnReLU3D_2", "conv1", _conv3d_as_2d),
        ("ConvBnReLU3D_3", "conv4", _conv3d),
        ("ConvBnReLU3D_4", "conv3", _conv3d_as_2d),
        ("ConvBnReLU3D_5", "conv6", _conv3d),
        ("ConvBnReLU3D_6", "conv5", _conv3d_as_2d),
    ]
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
    entries.append(
        ("params", f"{flax_reg}/Conv_0/kernel", f"{torch_reg}.prob.weight", _conv3d_as_2d)
    )
    entries.append(("params", f"{flax_reg}/Conv_0/bias", f"{torch_reg}.prob.bias", _vec))


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


def _entries(flat_params, num_stages: int) -> list:
    feature = next(
        p.split("/")[0] for p in flat_params if "FPN4" in p.split("/")[0]
    )
    entries: list = []
    _fpn4_entries(entries, feature)
    for s in range(num_stages):
        _reg2d_entries(entries, f"reg_stage{s + 1}", f"reg.{s}")
    if any(p.startswith("MonoDepthDecoder_0/") for p in flat_params):
        _mono_entries(entries)
    return entries


def jax_variables_to_state_dict(variables, num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """Convert JAX ``MVS4Net`` variables (``{"params", "batch_stats"}``, numpy
    or JAX arrays) into a ``state_dict`` for the port's ``MVS4Net``.

    Raises ``ValueError`` listing every leaf of the JAX tree that no table
    entry covers, so a partial conversion cannot pass silently."""
    flat = {col: _flatten(variables[col]) for col in ("params", "batch_stats")}
    entries = _entries(flat["params"], num_stages)

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


def jax_grads_to_port(grads, num_stages: int = 4) -> Dict[str, torch.Tensor]:
    """A flax-shaped gradient tree (``jax.grad`` with respect to
    ``variables["params"]``) -> ``{port parameter name: gradient}`` in the
    port's layouts. Raises ``ValueError`` on a leaf no entry covers."""
    flat = _flatten(grads)
    out: Dict[str, torch.Tensor] = {}
    for col, flax_path, torch_key, transform in _entries(flat, num_stages):
        if col == "params" and flax_path in flat:
            arr = transform(np.asarray(flat.pop(flax_path), dtype=np.float32))
            out[torch_key] = torch.tensor(np.ascontiguousarray(arr))
    if flat:
        raise ValueError(f"flax gradient leaves not covered: {sorted(flat)}")
    return out
