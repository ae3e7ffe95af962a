"""Plain float32 MVSTER: the eval forward, the train forward with the mono
decoder, the recipe's loss and Adam, written from the published network
(Wang et al., ECCV 2022; the reference repository's ``models/MVS4Net.py``
and ``models/mvs4net_utils.py``) for the FPN4 + Reg2D family with group
correlation and inverse depth.

It imports only ``torch``: nothing of the measured program, no kernel, no
cache, no capture. Activations are NCHW; parameters are read by the
reference repository's ``state_dict`` names (``feature.conv0.0.conv.weight``,
``reg.0.conv7.0.weight``, ...) from a plain dict of tensors. Warping is
``F.grid_sample`` (align corners, zeros padding) at the plane-sweep
coordinates; resizes are ``F.interpolate(align_corners=True)``.

``precision``: ``"float32"`` computes as stated (the caller turns TF32 off);
``"fp8"`` rounds both operands of every convolution and transposed
convolution, and the features each stage warps and correlates, to float8
e4m3, and their gradients to e5m2, each with a per-tensor scale: the
control a bf16 configuration is held against.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Float8 training's rounding: the operand to e4m3 and its gradient to
    e5m2, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float8 (``_Fp8``), back in float32."""
    return _Fp8.apply(t)


class Net:
    """The network over a parameter dict ``p`` and a config dict ``cfg``
    (the ``ModelConfig`` keys of the benchmark's configuration file).
    ``train`` selects train-mode BatchNorm (per view in the pyramid), the
    mono decoder and no confidence."""

    def __init__(self, p: Dict[str, torch.Tensor], cfg: Dict, *, train: bool = False,
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p = p
        self.cfg = cfg
        self.train = train
        self.q = _fp8 if precision == "fp8" else (lambda t: t)

    # -- layers ---------------------------------------------------------
    def conv(self, x, name, stride=1, padding=0, bias=False):
        w = self.p[f"{name}.weight"]
        b = self.p[f"{name}.bias"] if bias else None
        return F.conv2d(self.q(x), self.q(w), b, stride, padding)

    def bn(self, x, name, groups: int = 1):
        """BatchNorm over channel axis 1; in training the statistics of each
        of ``groups`` interleaved groups of the batch (fold index ``b*G + g``)."""
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        shape = [1, -1] + [1] * (x.dim() - 2)
        if not self.train:
            rm, rv = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
            y = (x - rm.view(shape)) / torch.sqrt(rv.view(shape) + BN_EPS)
            return y * w.view(shape) + b.view(shape)
        N = x.shape[0]
        xg = x.reshape(N // groups, groups, *x.shape[1:])
        dims = [0] + list(range(3, xg.dim()))
        mean = xg.mean(dim=dims, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=dims, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + BN_EPS)).reshape(x.shape)
        return y * w.view(shape) + b.view(shape)

    def cbr(self, x, name, stride=1, groups=1):
        k = self.p[f"{name}.conv.weight"].shape[-1]
        return F.relu(self.bn(self.conv(x, f"{name}.conv", stride, k // 2), f"{name}.bn", groups))

    # -- feature pyramid ------------------------------------------------
    def pyramid(self, x, views: int) -> List[torch.Tensor]:
        """``x [B*V, 3, H, W]`` -> four feature maps, coarse to fine."""
        skips = []
        for stem, n in (("conv0", 2), ("conv1", 3), ("conv2", 3), ("conv3", 3)):
            for i in range(n):
                name = f"feature.{stem}.{i}"
                stride = 2 if (i == 0 and stem != "conv0") else 1
                x = self.cbr(x, name, stride, views)
            skips.append(x)
        intra = skips[3]
        outs = [self.conv(intra, "feature.out1")]
        for lvl, skip in ((1, skips[2]), (2, skips[1]), (3, skips[0])):
            up = F.interpolate(intra, size=skip.shape[-2:], mode="bilinear", align_corners=True)
            intra = up + self.conv(skip, f"feature.inner{lvl}", bias=True)
            outs.append(self.conv(intra, f"feature.out{lvl + 1}", padding=1))
        return outs

    # -- one stage ------------------------------------------------------
    def aggregate(self, feats, rel, hypo, G: int):
        """Group correlation of each warped source view with the reference,
        fused over views by the softmax-over-depth attention: ``[B, G, D, h, w]``."""
        ref = feats[0]
        B, C, h, w = ref.shape
        D = hypo.shape[1]
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=ref.device),
                                torch.arange(w, dtype=torch.float32, device=ref.device),
                                indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(1, 3, 1, h * w)
        acc, norm = 0.0, 1e-8
        for v in range(1, len(feats)):
            m = rel[v - 1]                                         # [B, 4, 4]
            rot = m[:, :3, :3] @ pix.reshape(1, 3, h * w)          # [B, 3, hw]
            pts = rot[:, :, None, :] * hypo.reshape(B, 1, D, h * w) + m[:, :3, 3:4, None]
            z = pts[:, 2]
            z = torch.where(z == 0, torch.full_like(z, 1e-9), z)
            gx = pts[:, 0] / z / (w - 1) * 2 - 1
            gy = pts[:, 1] / z / (h - 1) * 2 - 1
            grid = torch.stack([gx, gy], dim=-1).reshape(B, D * h, w, 2)
            warped = F.grid_sample(feats[v], grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True).reshape(B, C, D, h, w)
            cor = (warped * ref[:, :, None]).reshape(B, G, C // G, D, h, w).mean(dim=2)
            wgt = torch.softmax(cor.sum(dim=1) / self.cfg["attn_temp"], dim=1) / math.sqrt(C)
            acc = acc + wgt[:, None] * cor
            norm = norm + wgt[:, None]
        return acc / norm

    def reg2d(self, cost, s: int):
        """Reg2D on ``cost [B, G, D, h, w]`` -> scores ``[B, D, h, w]``."""
        B, G, D, h, w = cost.shape
        r = f"reg.{s}"
        x = cost.permute(0, 2, 1, 3, 4).reshape(B * D, G, h, w)

        def mid(x, name):
            N, C, hh, ww = x.shape
            x5 = x.reshape(B, D, C, hh, ww).permute(0, 2, 1, 3, 4)
            y = F.conv3d(self.q(x5), self.q(self.p[f"{name}.conv.weight"]), None, 1, 1)
            y = y.permute(0, 2, 1, 3, 4).reshape(N, -1, hh, ww)
            return F.relu(self.bn(y, f"{name}.bn"))

        def down(x, name):
            wt = self.p[f"{name}.conv.weight"][:, :, 0]
            y = F.conv2d(self.q(x), self.q(wt), None, 2, 1)
            return F.relu(self.bn(y, f"{name}.bn"))

        def up(x, name):
            wt = self.p[f"{name}.0.weight"][:, :, 0]
            y = F.conv_transpose2d(self.q(x), self.q(wt), None, 2, 1, 1)
            return F.relu(self.bn(y, f"{name}.1"))

        w0 = self.p[f"{r}.conv0.conv.weight"][:, :, 0]
        conv0 = F.relu(self.bn(F.conv2d(self.q(x), self.q(w0), None, 1, 1), f"{r}.conv0.bn"))
        conv2 = mid(down(conv0, f"{r}.conv1"), f"{r}.conv2")
        conv4 = mid(down(conv2, f"{r}.conv3"), f"{r}.conv4")
        x = mid(down(conv4, f"{r}.conv5"), f"{r}.conv6")
        x = conv4 + up(x, f"{r}.conv7")
        x = conv2 + up(x, f"{r}.conv9")
        x = conv0 + up(x, f"{r}.conv11")
        wp = self.p[f"{r}.prob.weight"][:, :, 0]
        score = F.conv2d(self.q(x), self.q(wp), self.p[f"{r}.prob.bias"])
        return score.reshape(B, D, h, w)

    # -- the network ----------------------------------------------------
    def forward(self, imgs, projs, depth_values) -> Dict[str, Dict[str, torch.Tensor]]:
        """``imgs [B, V, H, W, 3]``, ``projs {stage: [B, V, 2, 4, 4]}``,
        ``depth_values [B, >=2]`` -> per stage ``depth``, ``attn_weight``,
        ``hypo_depth``, ``photometric_confidence`` (eval) and ``mono_depth``
        (train, stages 2-4)."""
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        x = imgs.float().permute(0, 1, 4, 2, 3).reshape(B * V, 3, H, W)
        feats = [f.reshape(B, V, *f.shape[1:]) for f in self.pyramid(x, V)]
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        inv_lo = inv_hi = None
        for s in range(4):
            D = cfg["ndepths"][s]
            h, w = feats[s].shape[-2:]
            t = torch.arange(D, dtype=torch.float32, device=imgs.device) / (D - 1)
            if s == 0:
                lo, hi = 1.0 / depth_values[:, -1], 1.0 / depth_values[:, 0]
                inv = lo[:, None] + (hi - lo)[:, None] * t[None]
                hypo = (1.0 / inv)[:, :, None, None].expand(B, D, h, w)
            else:
                inv = inv_hi[:, None] + (inv_lo - inv_hi)[:, None] * t[None, :, None, None]
                inv = F.interpolate(inv, size=(h, w), mode="bilinear", align_corners=True)
                hypo = 1.0 / inv
            hypo = hypo.contiguous()
            stage = projs[f"stage{s + 1}"].float()
            rel = [_relative(stage[:, v], stage[:, 0]) for v in range(1, V)]
            views = [self.q(feats[s][:, v]) for v in range(V)]
            cost = self.aggregate(views, rel, hypo, cfg["group_cor_dim"][s])
            score = self.reg2d(cost, s)
            idx = score.argmax(dim=1, keepdim=True)
            depth = torch.gather(hypo, 1, idx)[:, 0]
            o = {"depth": depth, "hypo_depth": hypo, "attn_weight": torch.softmax(score, dim=1),
                 "mono_feat": views[0], "score": score}
            if not self.train:
                o["photometric_confidence"] = torch.gather(score, 1, idx)[:, 0] / score.sum(1)
            itv = 1.0 / hypo[:, 2] - 1.0 / hypo[:, 1]
            r = cfg["depth_inter_r"][s]
            inv_lo = (1.0 / depth + r * itv).detach()
            inv_hi = (1.0 / depth - r * itv).detach()
            out[f"stage{s + 1}"] = o
        if self.train and cfg["mono"]:
            self.mono(out, depth_values)
        return out

    def mono(self, out, depth_values) -> None:
        """The mono depth decoder: stage ``i + 2``'s ``mono_depth`` from the
        reference-view features of stages ``i + 1`` and ``i + 2``."""
        min_disp = (1.0 / depth_values[:, 1])[:, None, None]
        max_disp = (1.0 / depth_values[:, 0])[:, None, None]
        for i in range(3):
            small = self.cbr(out[f"stage{i + 1}"]["mono_feat"],
                             f"mono_depth_decoder.convblocks.{i}")
            small = F.interpolate(small, scale_factor=2, mode="nearest")
            large = out[f"stage{i + 2}"]["mono_feat"]
            feat = self.conv(torch.cat([small, large], dim=1),
                             f"mono_depth_decoder.conv3x3.{i}", padding=1, bias=True)
            disp = torch.sigmoid(feat)[:, 0]
            out[f"stage{i + 2}"]["mono_depth"] = 1.0 / (min_disp + (max_disp - min_disp) * disp)


def _relative(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``K_src E_src E_ref^-1 K_ref^-1`` of two ``[B, 2, 4, 4]`` stacks
    (extrinsics, intrinsics in the top-left 3x3), inverted with
    ``torch.linalg.inv`` in float64."""
    def full(stack):
        stack = stack.double()
        k = torch.eye(4, dtype=stack.dtype, device=stack.device).repeat(stack.shape[0], 1, 1)
        k[:, :3, :3] = stack[:, 1, :3, :3]
        return k @ stack[:, 0]
    return (full(src) @ torch.linalg.inv(full(ref))).float()


# -- the recipe's loss --------------------------------------------------
def sinkhorn(gt, hypo, attn, mask, iters: int, eps: float = 1.0):
    """Entropic OT between the predicted depth-bin distribution and the
    one-hot bin nearest the ground truth, the reference's ``+cost/eps``
    kernel, masked mean over pixels."""
    B, D, H, W = attn.shape
    bins = torch.arange(D, dtype=torch.float32, device=attn.device)
    cost = (bins[:, None] - bins[None, :]).abs()
    nu = attn.permute(0, 2, 3, 1).reshape(B, H * W, D)
    gt_idx = (hypo - gt[:, None]).abs().argmin(dim=1).reshape(B, H * W)
    mu = F.one_hot(gt_idx, D).float()
    log_mu, log_nu = torch.log(mu + 1e-12), torch.log(nu + 1e-12)
    k = cost / eps
    u, v = torch.zeros_like(log_nu), torch.zeros_like(log_mu)
    for _ in range(iters):
        v = log_mu - torch.logsumexp(k + u[..., None], dim=-2)
        u = log_nu - torch.logsumexp(k + v[..., None, :], dim=-1)
    per_px = (torch.exp(k + u[..., None] + v[..., None, :]) * cost).sum(dim=(-1, -2))
    m = mask.reshape(B, H * W).float()
    return (per_px * m).sum() / m.sum().clamp(min=1.0)


def recipe_loss(out, depth_gt, mask, l1_lw: float, ot_lw: float, ot_iter: int):
    """Sum over stages of ``l1_lw * L1(mono depth) + ot_lw * OT``, and the
    terms: ``{"s{s}_c_loss": OT, "s{s}_d_loss": L1}`` per stage."""
    total, terms = 0.0, {}
    for s in range(4):
        o = out[f"stage{s + 1}"]
        gt, m = depth_gt[f"stage{s + 1}"].float(), mask[f"stage{s + 1}"] > 0.5
        ot = sinkhorn(gt, o["hypo_depth"], o["attn_weight"], m, ot_iter)
        l1 = 0.0
        if "mono_depth" in o:
            mf = m.float()
            l1 = ((o["mono_depth"] - gt).abs() * mf).sum() / mf.sum().clamp(min=1.0)
        total = total + l1_lw * l1 + ot_lw * ot
        terms[f"s{s}_c_loss"], terms[f"s{s}_d_loss"] = ot, l1
    return total, terms


def adam_step(params, grads, state, lr: float, wd: float, step: int,
              betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam update in place, L2 weight decay added to the gradient."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name] + wd * p
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        m_hat = m / (1 - b1 ** step)
        v_hat = v / (1 - b2 ** step)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))


def warmup_lr(base_lr: float, step: int, warmup_iters: int = 500, factor: float = 1 / 3) -> float:
    """The recipe's WarmupMultiStepLR before its first milestone."""
    if step >= warmup_iters:
        return base_lr
    a = step / warmup_iters
    return base_lr * (factor * (1 - a) + a)
