"""Projective geometry for multi-view stereo in PyTorch, NHWC layout.

Counterpart of the JAX package's ``core/geometry.py``, with the same
conventions: images and feature maps are ``[B, H, W, C]``, depth hypotheses
``[B, D, H, W]``, projection inputs ``[B, 2, 4, 4]`` stacks of (extrinsics,
intrinsics in the top-left 3x3). Every function here keeps the JAX order of
operations, so that float32 results agree to rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def compose_projection(proj_mat: torch.Tensor) -> torch.Tensor:
    """``[..., 2, 4, 4]`` (extrinsics, intrinsics) -> ``[..., 4, 4]`` with
    ``P[:3, :4] = K @ E[:3, :4]`` and the extrinsics' bottom row."""
    extr = proj_mat[..., 0, :, :]
    intr = proj_mat[..., 1, :3, :3]
    top = intr @ extr[..., :3, :4]
    return torch.cat([top, extr[..., 3:4, :]], dim=-2)


def intrinsics_inverse(intr: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an upper-triangular 3x3 intrinsics matrix.

    Never ``torch.linalg.inv``: inverting the composed K·E product in float32
    costs ~1e-2 px of warp accuracy, the analytic form keeps <1e-4 px."""
    fx = intr[..., 0, 0]
    s = intr[..., 0, 1]
    cx = intr[..., 0, 2]
    fy = intr[..., 1, 1]
    cy = intr[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    row0 = torch.stack(
        [1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1
    )
    row1 = torch.stack([zero, 1.0 / fy, -cy / fy], -1)
    row2 = torch.stack([zero, zero, one], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def extrinsics_inverse(extr: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 ``[R|t]`` as ``[Rᵀ | -Rᵀ t]``, no solve."""
    rot = extr[..., :3, :3]
    t = extr[..., :3, 3:4]
    rot_t = rot.transpose(-1, -2)
    top = torch.cat([rot_t, -rot_t @ t], dim=-1)
    # the bottom row [0, 0, 0, 1] made on the device (no host copy)
    bottom = torch.zeros_like(extr[..., 3:4, :])
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def relative_projection(
    src_proj_stack: torch.Tensor, ref_proj_stack: torch.Tensor
) -> torch.Tensor:
    """Relative pixel transform ``K_src · E_src · E_ref⁻¹ · K_ref⁻¹`` from
    two ``[..., 2, 4, 4]`` stacks, built from the analytic inverses.
    Returns ``[..., 4, 4]``."""
    e_src = src_proj_stack[..., 0, :, :]
    k_src = src_proj_stack[..., 1, :3, :3]
    e_ref = ref_proj_stack[..., 0, :, :]
    k_ref = ref_proj_stack[..., 1, :3, :3]
    rel_e = e_src @ extrinsics_inverse(e_ref)
    k_ref_inv = intrinsics_inverse(k_ref)
    top = k_src @ rel_e[..., :3, :4]
    top = torch.cat([top[..., :, :3] @ k_ref_inv, top[..., :, 3:4]], dim=-1)
    bot = torch.cat(
        [rel_e[..., 3:4, :3] @ k_ref_inv, rel_e[..., 3:4, 3:4]], dim=-1
    )
    return torch.cat([top, bot], dim=-2)


def grid_sample_2d(img: torch.Tensor, coords_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of ``img [B, H, W, C]`` at PIXEL coordinates
    ``coords_xy [B, ..., 2]`` (x, y), zeros padding, align_corners.

    Each of the four corner taps contributes 0 where that corner lies
    outside the image. Not ``F.grid_sample``: its normalise/denormalise
    round trip changes float32 rounding. Returns ``[B, ..., C]`` in the
    dtype of ``img``."""
    B, H, W, C = img.shape
    batch_shape = coords_xy.shape[:-1]
    coords = coords_xy.reshape(B, -1, 2)
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    # a coordinate beyond int32 (or NaN) is far outside the image: clamp it
    # to a value that is still out of bounds before the integer cast
    x0i = x0.nan_to_num(-2.0).clamp(-2.0, W + 1.0).to(torch.int64)
    y0i = y0.nan_to_num(-2.0).clamp(-2.0, H + 1.0).to(torch.int64)
    img_flat = img.reshape(B, H * W, C)

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(
            img_flat, 1, idx.unsqueeze(-1).expand(-1, -1, C)
        )
        w = torch.where(valid, w, torch.zeros_like(w)).to(img.dtype)
        return vals * w.unsqueeze(-1)

    out = (
        tap(x0i, y0i, (1.0 - lx) * (1.0 - ly))
        + tap(x0i + 1, y0i, lx * (1.0 - ly))
        + tap(x0i, y0i + 1, (1.0 - lx) * ly)
        + tap(x0i + 1, y0i + 1, lx * ly)
    )
    return out.reshape(*batch_shape, C)


def warp_coords_xy(rel_proj: torch.Tensor, depth_values: torch.Tensor):
    """Source-pixel coordinates of every (ref pixel, hypothesis) as two
    ``[B, D, H, W]`` float32 planes: ``rot·[u, v, 1]·d + t``, then the
    perspective divide with the reference's guard ``z == 0 -> 1e-9``."""
    B, D, H, W = depth_values.shape
    dev = depth_values.device
    m = rel_proj[:, :3, :].float().reshape(B, 12, 1, 1, 1)
    u = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    v = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    d = depth_values.float()

    def row(i):
        return (m[:, 4 * i] * u + m[:, 4 * i + 1] * v + m[:, 4 * i + 2]) * d + m[:, 4 * i + 3]

    xn, yn, z = row(0), row(1), row(2)
    z = torch.where(z == 0.0, torch.full_like(z, 1e-9), z)
    return xn / z, yn / z


def warp_coords(rel_proj: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """:func:`warp_coords_xy` stacked as ``[B, D, H, W, 2]``."""
    return torch.stack(warp_coords_xy(rel_proj, depth_values), dim=-1)


@functools.lru_cache(maxsize=64)
def align_corners_taps(n_out: int, n_in: int):
    """Per-output index and weights of a 1-D align-corners linear resize,
    computed in float64 as the JAX interpolation matrix is: ``(i0, w0, w1)``
    with ``i0`` clamped to ``n_in - 2`` and the weights rounded once to
    float32. Numpy arrays; cached per size."""
    if n_out == 1 or n_in == 1:
        return (np.zeros(n_out, np.int64), np.ones(n_out, np.float32),
                np.zeros(n_out, np.float32))
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - i0
    return i0, (1.0 - frac).astype(np.float32), frac.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_taps(n_out: int, n_in: int, device: torch.device, dtype: torch.dtype):
    """:func:`align_corners_taps` as tensors on ``device``: ``(i0, i1, w0,
    w1)``, the weights in ``dtype``, cached per ``(n_out, n_in, device,
    dtype)`` so that a call copies nothing from the host (as
    ``ops/kernels/topdown.py:_taps``)."""
    i0, w0, w1 = align_corners_taps(n_out, n_in)
    i0 = torch.as_tensor(i0, device=device)
    return (i0, (i0 + 1).clamp(max=n_in - 1),
            torch.as_tensor(w0, device=device).to(dtype),
            torch.as_tensor(w1, device=device).to(dtype))


def _resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    i0, i1, w0, w1 = _device_taps(n_out, x.shape[axis], x.device, x.dtype)
    shape = [1] * x.dim()
    shape[axis] = n_out
    return x.index_select(axis, i0) * w0.view(shape) + x.index_select(axis, i1) * w1.view(shape)


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W, C]`` as ``F.interpolate(...,
    align_corners=True)``: rows first, then columns, two taps each."""
    H, W = x.shape[-3:-1]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    x = _resize_axis(x, x.dim() - 3, Ho)
    return _resize_axis(x, x.dim() - 2, Wo)


@functools.lru_cache(maxsize=64)
def align_corners_matrix(n_out: int, n_in: int) -> np.ndarray:
    """The 1-D align-corners resize as an ``[n_out, n_in]`` float32 matrix
    of :func:`align_corners_taps` (two taps per row)."""
    i0, w0, w1 = align_corners_taps(n_out, n_in)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), w0)
    np.add.at(m, (rows, np.minimum(i0 + 1, n_in - 1)), w1)
    return m


@functools.lru_cache(maxsize=64)
def _device_matrix(n_out: int, n_in: int, device: torch.device, dtype: torch.dtype):
    """:func:`align_corners_matrix` on ``device`` in ``dtype``, cached."""
    return torch.as_tensor(align_corners_matrix(n_out, n_in), device=device).to(dtype)


def resize_align_corners_adjoint(dy: torch.Tensor, in_hw) -> torch.Tensor:
    """Adjoint of :func:`resize_align_corners` from ``in_hw``: ``dy [N, Ho,
    Wo, C] -> [N, H, W, C]``, the transposed interpolation matrices applied
    to both axes, in the dtype of ``dy``."""
    N, Ho, Wo, C = dy.shape
    H, W = in_hw
    mh = _device_matrix(Ho, H, dy.device, dy.dtype)
    mw = _device_matrix(Wo, W, dy.device, dy.dtype)
    t = torch.matmul(dy.permute(0, 1, 3, 2), mw)             # [N, Ho, C, W]
    t = torch.matmul(mh.t(), t.reshape(N, Ho, C * W))        # [N, H, C*W]
    return t.reshape(N, H, C, W).permute(0, 1, 3, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of ``[..., H, W, C]``: ``out[i] = in[i // 2]``."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
