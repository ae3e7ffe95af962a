"""Checks of the port's paths through the kernels against the plain versions.

``chip_smoke.py`` and the card tests (``tests/test_torch_port_cuda.py``)
both call these, so that each tolerance is stated once. Every check raises
``AssertionError`` on a failure and returns what it measured.

- ``check_chain_backward``: the top-down chain's ``autograd.Function`` (K2
  forward, K2 re-deriving ``u`` in the backward) against autograd through
  the plain chain.
- ``check_train_step``: one float32 train step on a device against the
  same step on the CPU, where every kernel wrapper takes its plain version.
- ``check_forward``: the float32 eval forward on a device against the CPU's,
  at any FPN base and group counts (the widths every kernel must take).
- ``check_pipeline``: the eval pipeline (depth maps of every view, the
  consistency filter, the fused point cloud; ``run_pipeline``) on a device
  against the same pipeline on the CPU.
- ``compare_space``: the row-sharded eval forward (``--space``) against the
  unsharded forward.
- ``check_ddp_step``: train steps through ``parallel.mesh.data_parallel``
  on a world of one rank against runs of the bare ``TrainStep`` from the
  same seed, within a multiple of their own run-to-run noise (bit for bit
  where the step is deterministic).
- ``compare_debug_dumps``: the debug dumps (``utils/debug.py``) of a
  device against the CPU's.
- ``check_graph_forward``, ``check_graph_eval_step``,
  ``check_graph_train_step``: the captured paths (``utils/graphs.py``)
  replayed against their eager calls: the eval forward and the eval step
  bit for bit, the train step within a multiple of the eager step's own
  run-to-run noise.

Checks that read intermediate values on the host (``train_step_grads``,
the DDP runs) run eagerly (``graphs.eager``).

Why the train-step comparison pins two things. The float32 gradient of
this network is ill-conditioned in two places, on any device: moving every
weight by 1e-7 relative on the CPU (``python -m
deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.checks`` prints
the table) moves

- the next stage's hypotheses, where an argmax near-tie breaks the other
  way, and with them every gradient of the later stages;
- with the hypotheses unmoved, the gradient at a Reg2D's input, the cost
  volume, by 1e-2 of its max and more (train-mode BatchNorm over small
  coarse grids, ReLU near-ties), and likewise the gradients of the FPN
  stem's weights.

So the device's step takes the CPU's hypotheses and, in the backward, the
CPU's gradient at every cost volume and mono depth map (``pin``). The
gradients that the port's kernels compute from there are then compared on
equal terms and held tightly: the FPN outputs' gradients (the group
correlation and K3 make them) and the parameters of the top-down chain
(K2's backward) and of the mono decoder. The weights of the stem and of the
Reg2D nets, which no kernel of the port differentiates, are held to a
limit that a lost, doubled or sign-flipped gradient breaks.

The model variants (``variant``: ``ModelConfig`` fields) take the same
checks. ASFF's weights are ill-conditioned as the stem's are, and with ASFF
the pyramid's outputs become cuts as well: their gradients come back
through ASFF's ReLUs and train-mode BatchNorm, so the device takes the
CPU's there and they are held to the loose limit. The card also starts from
parameters that a trained network would hold (``seeded_params``): a
ConvNeXt layer scale of order 1, DCN offsets between pixels.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional
from unittest import mock

import numpy as np
import torch

from .config import LossConfig, ModelConfig, setup_device
from .eval.fusion import FusionConfig
from .ops.kernels.topdown import topdown_level_ref
from .ops.topdown_chain import TopDownChain
from .utils import graphs

# relative to max(1, max|plain|): float32 sums in another order; in bf16
# the Function keeps du, dprev and dskip in bf16 (as the JAX package's
# backward does) while autograd of the plain chain stays in float32 inside
# each level, so some six bf16 roundings (2^-8 each) may lie between them
CHAIN_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# the train step, device against CPU: the loss relative; gradients as
# max|device - cpu| / max|cpu| per tensor. The CPU's own noise (weights
# moved by 1e-7 and 1e-6, pinned) is printed by ``main``.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_EACH = 1e-3
TRAIN_GRAD_ILL_EACH = 0.5

# parameters whose float32 gradient is ill-conditioned (see above; ASFF's
# as the stem's)
ILL_CONDITIONED = ("feature.conv", "reg.", "asff.")

# the model variants, each the flagship with the ``ModelConfig`` fields
# given changed: the variants of ``MVS4Net`` that the JAX package builds
VARIANTS = (
    ("pos_enc_sine", {"pos_enc": 1}),
    ("pos_enc_learned", {"pos_enc": 2}),
    ("reg3d", {"reg_mode": "reg3d"}),
    ("agg_cam", {"agg_type": "ConvBnReLU3D_CAM"}),
    ("agg_dcam", {"agg_type": "ConvBnReLU3D_DCAM"}),
    ("agg_pam", {"agg_type": "ConvBnReLU3D_PAM"}),
    ("agg_pdam", {"agg_type": "ConvBnReLU3D_PDAM"}),
    ("gn", {"gn": True}),
    ("asff", {"asff": True}),
    ("fpn_convnext", {"arch_mode": "fpn_convnext"}),
    ("fpn_convnext4", {"arch_mode": "fpn_convnext4"}),
    ("dcn", {"dcn": True}),
    ("gn_dcn", {"gn": True, "dcn": True}),
)

# the DTU recipe's loss (scripts/train_dtu.sh: --l1ce_lw 0.003,1, mono,
# inverse depth, 3 Sinkhorn iterations)
RECIPE_LOSS = LossConfig(stage_lw=(1.0, 1.0, 1.0, 1.0), l1_lw=0.003, ot_lw=1.0, ot_iter=3,
                         inverse_depth=True, mono=True)

CHAIN_LEVELS = ((32, 32), (16, 16), (8, 8))   # (Cs, Co) of the three levels


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def _median(xs):
    return sorted(xs)[len(xs) // 2]


# ------------------------------------------------------------ the chain --


def chain_inputs(N: int, Hh: int, Wh: int, dtype, device, generator: torch.Generator):
    """Random chain inputs: ``intra [N,Hh,Wh,64]``, the skips and output
    gradients of the three levels (2x, 4x, 8x the size of ``intra``) in
    ``dtype``, float32 weights at fan-in scale. Returns ``(leaves, grads)``
    in the argument order of ``TopDownChain.apply``."""

    def rnd(*shape, scale=1.0, dt=dtype):
        x = torch.randn(shape, generator=generator, device=device) * scale
        return x.to(dt)

    leaves = [rnd(N, Hh, Wh, 64)]
    leaves += [rnd(N, Hh << (i + 1), Wh << (i + 1), cs) for i, (cs, _) in enumerate(CHAIN_LEVELS)]
    for cs, co in CHAIN_LEVELS:
        leaves += [rnd(64, cs, 1, 1, scale=cs ** -0.5, dt=torch.float32),
                   rnd(64, scale=0.1, dt=torch.float32),
                   rnd(co, 64, 3, 3, scale=576 ** -0.5, dt=torch.float32)]
    grads = [rnd(N, Hh << (i + 1), Wh << (i + 1), co) for i, (_, co) in enumerate(CHAIN_LEVELS)]
    return leaves, grads


def chain_function_grads(leaves, grads):
    """Outputs and leaf gradients through ``TopDownChain``."""
    xs = [x.detach().requires_grad_() for x in leaves]
    outs = TopDownChain.apply(*xs)
    torch.autograd.backward(outs, grads)
    return list(outs), [x.grad for x in xs]


def chain_plain_grads(leaves, grads):
    """Outputs and leaf gradients by autograd through ``topdown_level_ref``
    per level."""
    xs = [x.detach().requires_grad_() for x in leaves]
    cur, outs = xs[0], []
    for i in range(len(CHAIN_LEVELS)):
        o, cur = topdown_level_ref(cur, xs[1 + i], *xs[4 + 3 * i: 7 + 3 * i], with_u=True)
        outs.append(o)
    torch.autograd.backward(outs, grads)
    return outs, [x.grad for x in xs]


CHAIN_NAMES = ["o2", "o3", "o4", "intra", "skip2", "skip3", "skip4"] + [
    f"{n}{lvl + 2}" for lvl in range(3) for n in ("wi", "bi", "wo")]


def check_chain_backward(leaves, grads) -> Dict[str, object]:
    """The Function's outputs and the gradients of intra, the skips, wi, bi
    and wo against autograd of the plain chain, each within
    ``CHAIN_TOLERANCE`` of max(1, max|plain|) for the dtype of ``intra``."""
    tol = CHAIN_TOLERANCE[leaves[0].dtype]
    got_o, got_g = chain_function_grads(leaves, grads)
    want_o, want_g = chain_plain_grads(leaves, grads)
    worst = {}
    for name, a, b in zip(CHAIN_NAMES, [*got_o, *got_g], [*want_o, *want_g]):
        worst[name] = _max_rel(a, b)
        if worst[name] > tol:
            raise AssertionError(f"chain {leaves[0].dtype} {name}: max rel diff "
                                 f"{worst[name]} > {tol}")
    return {"max_rel_diff": max(worst.values()), "worst": max(worst, key=worst.get),
            "tolerance": tol}


# ------------------------------------------------------- the train step --


def small_step_model(seed: int = 3, perturb: float = 0.0, perturb_seed: int = 0,
                     base: int = 8, group_cor_dim=(8, 8, 4, 4),
                     variant: Optional[Dict[str, object]] = None):
    """The flagship configuration in float32 on the CPU, with the
    ``ModelConfig`` fields of ``variant`` changed, weights drawn from
    ``seed`` (``seeded_params``), at FPN base ``base`` and
    ``group_cor_dim``; ``perturb`` moves every weight by that relative
    amount (normal, from ``perturb_seed``)."""
    from .models import MVS4Net

    cfg = ModelConfig(group_cor=True, group_cor_dim=tuple(group_cor_dim), inverse_depth=True,
                      mono=True, attn_temp=2.0, dtype="float32", fpn_base_channel=base,
                      **(variant or {}))
    gen = torch.Generator().manual_seed(seed)
    model = seeded_params(MVS4Net(cfg, device="cpu", generator=gen), gen)
    if perturb:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen))
    return model


def small_step_batch(device):
    """Two plane scenes of three 64x128 views, on ``device``."""
    from .data.synthetic import batch_samples, batch_to_torch, make_plane_scene

    scenes = [make_plane_scene(V=3, H=64, W=128, seed=i) for i in range(2)]
    return batch_to_torch(batch_samples(scenes), device)


def train_step_grads(model, batch, pin: Optional[Dict[str, list]] = None):
    """One train step of ``model`` on ``batch`` (recipe loss, Adam at lr
    1e-3, wd 1e-4): ``{"loss", "grads" (per parameter), "acts" (the FPN
    outputs' gradients, o1-o4), "seen"}``, tensors on the CPU. ``seen``
    holds the hypotheses of stages 2-4 (``"hypo"``) and the gradient at
    each cut (``"cuts"``): each stage's cost volume (a Reg2D's input), then
    each mono depth map. With ``pin``, the ``seen`` of another run, the
    step takes that run's hypotheses and, in the backward, its gradients at
    the cuts in place of its own."""
    from .models import mvs4net as net
    from .train.step import make_optimizer, make_train_step

    acts: Dict[str, torch.Tensor] = {}
    seen: Dict[str, object] = {"hypo": [], "cuts": [], "acts": acts}

    def pinned(schedule):
        def fn(*args, **kwargs):
            hypo = schedule(*args, **kwargs)
            if pin is not None:
                hypo = pin["hypo"][len(seen["hypo"])].to(hypo.device, hypo.dtype)
            seen["hypo"].append(hypo.detach().cpu())
            return hypo
        return fn

    def cut(t):
        k = len(seen["cuts"])
        seen["cuts"].append(None)

        def swap(g):
            seen["cuts"][k] = g.detach().cpu()
            return None if pin is None else pin["cuts"][k].to(g.device, g.dtype)

        t.register_hook(swap)

    # with ASFF, the pyramid's outputs are cuts too: ASFF's ReLUs and
    # train-mode BatchNorm over small grids stand between them and the
    # stage features, as the stem's stand before them
    feature_cut = getattr(model, "asff", None) is not None

    def keep(name, t):
        def swap(g):
            acts[name] = g.detach().float().cpu()
            if feature_cut and pin is not None:
                return pin["acts"][name].to(g.device, g.dtype)
            return None

        t.register_hook(swap)

    hooks = [reg.register_forward_hook(lambda m, i, o: cut(i[0])) for reg in model.reg]
    hooks.append(model.mono_depth_decoder.register_forward_hook(
        lambda m, i, out: [cut(t) for t in out] and None))
    hooks.append(model.feature.register_forward_hook(
        lambda m, i, out: [keep(f"o{k + 1}", o) for k, o in enumerate(out)] and None))
    try:
        # eager: the hooks read the step's tensors on the host
        with mock.patch.object(net, "schedule_inverse_range",
                               pinned(net.schedule_inverse_range)), \
                mock.patch.object(net, "schedule_range", pinned(net.schedule_range)), \
                graphs.eager():
            step = make_train_step(model, RECIPE_LOSS, make_optimizer(model, 1e-4),
                                   lambda i: 1e-3)
            loss = step(batch)["loss"].item()
    finally:
        for h in hooks:
            h.remove()
    # a parameter that autograd never reached reads as a zero gradient
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()}
    return {"loss": loss, "grads": grads, "acts": acts, "seen": seen, "feature_cut": feature_cut}


def grad_gaps(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per tensor ``max|got - want| / max|want|``. The reg nets'
    ``prob.bias`` are left out: their gradient is analytically zero (the
    softmax over D ignores a constant added to every score)."""
    return {n: ((got[n] - w).abs().max() / w.abs().max()).item()
            for n, w in want.items() if not n.endswith("prob.bias")}


def train_step_gaps(cpu: Dict, dev: Dict) -> Dict[str, Dict[str, float]]:
    """The gaps of run ``dev`` from run ``cpu``, by group: ``acts`` (the
    FPN outputs' gradients), ``kernel_fed`` (the top-down chain's, the mono
    decoder's and the other variants' parameters), ``ill`` (the stem's, the
    regularizers' and ASFF's, and, where the pyramid's outputs are cuts,
    their gradients)."""
    gaps = grad_gaps(cpu["grads"], dev["grads"])
    acts = grad_gaps(cpu["acts"], dev["acts"])
    ill = {n: v for n, v in gaps.items() if n.startswith(ILL_CONDITIONED)}
    if cpu["feature_cut"]:
        ill.update({f"{n} (pyramid output)": v for n, v in acts.items()})
        return {"kernel_fed": {n: v for n, v in gaps.items() if n not in ill}, "ill": ill}
    return {
        "acts": acts,
        "kernel_fed": {n: v for n, v in gaps.items() if n not in ill},
        "ill": ill,
    }


def compare_train_step(cpu: Dict, dev: Dict, what: str = "device") -> Dict[str, object]:
    """Hold a pinned run ``dev`` to ``cpu``: the loss within
    ``TRAIN_LOSS_RTOL``; a nonzero gradient on every parameter (the
    ``prob.bias`` need none), the guard against gradients that stop at a
    kernel; the FPN outputs' gradients and the kernel-fed parameters each
    within ``TRAIN_GRAD_EACH``; the stem and Reg2D weights each within
    ``TRAIN_GRAD_ILL_EACH``."""
    if abs(dev["loss"] - cpu["loss"]) > TRAIN_LOSS_RTOL * abs(cpu["loss"]):
        raise AssertionError(f"train loss {what} {dev['loss']} vs cpu {cpu['loss']}")
    for name, got in dev["grads"].items():
        if not name.endswith("prob.bias") and got.abs().max().item() == 0.0:
            raise AssertionError(f"{name}: no gradient on {what}")
    limits = {"acts": TRAIN_GRAD_EACH, "kernel_fed": TRAIN_GRAD_EACH,
              "ill": TRAIN_GRAD_ILL_EACH}
    out: Dict[str, object] = {"loss_device": dev["loss"], "loss_cpu": cpu["loss"],
                              "params": len(cpu["grads"])}
    for group, gaps in train_step_gaps(cpu, dev).items():
        worst = max(gaps, key=gaps.get)
        if gaps[worst] > limits[group]:
            raise AssertionError(f"{what} {group} gradient {worst}: {gaps[worst]} of its max "
                                 f"from the cpu's, limit {limits[group]}")
        out[group] = {"tensors": len(gaps), "median": _median(list(gaps.values())),
                      "max": gaps[worst], "worst": worst, "limit": limits[group]}
    return out


def check_train_step(device, seed: int = 3, base: int = 8, group_cor_dim=(8, 8, 4, 4),
                     variant: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """One float32 train step of ``small_step_model(seed, base=base,
    group_cor_dim=group_cor_dim, variant=variant)`` on ``small_step_batch``
    on ``device``, pinned to the same step on the CPU and held to it by
    ``compare_train_step``; ``device`` is set up by ``config.setup_device``
    (TF32 off)."""
    device = setup_device(device)
    kw = {"base": base, "group_cor_dim": group_cor_dim, "variant": variant}
    cpu = train_step_grads(small_step_model(seed, **kw), small_step_batch("cpu"))
    dev = train_step_grads(small_step_model(seed, **kw).to(device), small_step_batch(device),
                           pin=cpu["seen"])
    return compare_train_step(cpu, dev, str(device))


# ------------------------------------------------------ the eval forward --

# device against CPU, float32, per stage: the attention weights within
# 1e-3 and the depth equal (rtol 1e-5) at >= 99% of pixels (argmax
# near-ties may flip)
FORWARD_ATTN_ATOL = 1e-3
FORWARD_DEPTH_AGREEMENT = 0.99


def check_forward(device, base: int = 8, group_cor_dim=(8, 8, 4, 4), seed: int = 1,
                  hw=(64, 128), views: int = 3,
                  variant: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """The float32 eval forward of the flagship model (group correlation,
    inverse depth, attn_temp 2, mono), with the ``ModelConfig`` fields of
    ``variant`` changed, at FPN base ``base`` and
    ``group_cor_dim``, weights and BatchNorm statistics from ``seed``
    (``seeded_model``), on a plane scene of ``views`` views at ``hw``, on
    ``device`` (``config.setup_device``) against the CPU: per stage the
    attention within ``FORWARD_ATTN_ATOL`` and the depth equal at
    ``FORWARD_DEPTH_AGREEMENT`` of the pixels."""
    from .data.synthetic import batch_samples, batch_to_torch, make_plane_scene

    device = setup_device(device)
    cfg = ModelConfig(group_cor=True, group_cor_dim=tuple(group_cor_dim), inverse_depth=True,
                      mono=True, attn_temp=2.0, dtype="float32", fpn_base_channel=base,
                      **(variant or {}))
    scene = batch_samples([make_plane_scene(V=views, H=hw[0], W=hw[1], seed=0)])
    outs = []
    for dev in ("cpu", device):
        model = seeded_model(cfg, seed, dev)
        b = batch_to_torch(scene, dev)
        with torch.inference_mode():
            outs.append(model(b["imgs"], b["proj_matrices"], b["depth_values"]))
    want, got = outs
    worst = {}
    for s in range(1, 5):
        g = {k: v.float().cpu() for k, v in got[f"stage{s}"].items()}
        w = want[f"stage{s}"]
        if g["depth"].shape != w["depth"].shape or not torch.isfinite(g["depth"]).all():
            raise AssertionError(f"base {base} stage{s}: depth {tuple(g['depth'].shape)} "
                                 "not finite or misshaped")
        attn = (g["attn_weight"] - w["attn_weight"]).abs().max().item()
        same = torch.isclose(g["depth"], w["depth"], rtol=1e-5, atol=0).float().mean().item()
        if attn > FORWARD_ATTN_ATOL or same < FORWARD_DEPTH_AGREEMENT:
            raise AssertionError(f"base {base} {tuple(group_cor_dim)} {variant or ''} stage{s} "
                                 f"on {device}: "
                                 f"attn diff {attn}, depth agreement {same}")
        worst[f"stage{s}"] = {"attn_max_abs_diff": attn, "depth_agreement": same}
    return {"base": base, "group_cor_dim": list(group_cor_dim), **worst}


def rounding_noise(seed: int, perturb: float, perturb_seed: int) -> Dict[str, object]:
    """The CPU's own noise in the comparison: the step with every weight
    moved by ``perturb`` against the step without, unpinned and pinned;
    the largest gap per group, whether the hypotheses moved, and the
    unpinned gap at each cost volume's gradient."""
    cpu = train_step_grads(small_step_model(seed), small_step_batch("cpu"))
    row: Dict[str, object] = {"seed": seed, "perturb": perturb, "perturb_seed": perturb_seed}
    for name, pin in (("unpinned", None), ("pinned", cpu["seen"])):
        run = train_step_grads(small_step_model(seed, perturb, perturb_seed),
                               small_step_batch("cpu"), pin=pin)
        if pin is None:
            row["hypotheses_moved"] = any(not torch.equal(a, b) for a, b in
                                          zip(cpu["seen"]["hypo"], run["seen"]["hypo"]))
            row["cost_volume_grad_gaps"] = [
                ((b - a).abs().max() / a.abs().max()).item()
                for a, b in zip(cpu["seen"]["cuts"][:4], run["seen"]["cuts"][:4])]
        row[name] = {g: max(v.values()) for g, v in train_step_gaps(cpu, run).items()}
    return row


# ----------------------------------------------------- the eval pipeline --

# the filter settings of scripts/eval_dtu.sh
EVAL_DTU_FUSION = FusionConfig(photomask=0.3, geomask=2, condmask_pixel=1.0,
                               condmask_depth=0.01)

# device against CPU, float32: argmax near-ties may flip a pixel's depth and
# with it the masks and points around it, never more than a percent of them
PIPELINE_DEPTH_AGREEMENT = 0.99
PIPELINE_MASK_AGREEMENT = 0.99
PIPELINE_POINTS_RTOL = 0.01

# the card-against-CPU pipeline: its weight seed, view count and size
PIPELINE_CHECK_SEED = 7
PIPELINE_CHECK_VIEWS = 4
PIPELINE_CHECK_HW = (64, 128)


def eval_dtu_config(dtype: str = "float32") -> ModelConfig:
    """The model of scripts/eval_dtu.sh: group correlation (8,8,4,4),
    ndepths 8,8,4,4, inverse depth, attn_temp 2, no mono."""
    return ModelConfig(group_cor=True, group_cor_dim=(8, 8, 4, 4), ndepths=(8, 8, 4, 4),
                       depth_inter_r=(0.5, 0.5, 0.5, 1.0), inverse_depth=True, attn_temp=2.0,
                       dtype=dtype)


def seeded_params(model, gen: torch.Generator):
    """``model`` with the parameters that start at a constant drawn from
    ``gen`` instead, as a trained network's are: the ConvNeXt blocks'
    layer scale ``gamma`` in [0.5, 1] (at its initial 1e-6 every pyramid
    output is ~1e-6, and the argmax over near-equal scores breaks by
    rounding), and the DCN heads' offset convs at a fraction of a pixel (at
    zero every tap sits on a pixel centre)."""
    from .models.fpn import ConvNeXtBlock, DeformConv2d

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=gen) * 0.5 + 0.5)
            if isinstance(m, DeformConv2d):
                w, b = m.conv_offset.weight, m.conv_offset.bias
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=gen) * 0.3 * fan_in ** -0.5)
                b.copy_(torch.randn(b.shape, generator=gen) * 0.3)
    return model


def seeded_model(cfg: ModelConfig, seed: int, device):
    """``MVS4Net(cfg)`` with weights drawn from ``seed`` (``seeded_params``)
    and its BatchNorm, GroupNorm and LayerNorm affine parameters and
    running statistics drawn away from identity (as a trained network's
    are), built on the CPU and moved to ``device``."""
    from .models import MVS4Net
    from .models.layers import GroupNorm, LayerNorm, TorchBatchNorm

    gen = torch.Generator().manual_seed(seed)
    model = seeded_params(MVS4Net(cfg, device="cpu", generator=gen), gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (TorchBatchNorm, GroupNorm, LayerNorm)):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
            if isinstance(m, TorchBatchNorm):
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
    return model.to(device)


def run_pipeline(model, dataset, device, cfg: FusionConfig = EVAL_DTU_FUSION,
                 nview_filter: int = 4, ply_path: Optional[str] = None,
                 forward=None) -> Dict[str, object]:
    """The eval CLI's path without its image files: the depth maps of every
    reference view of ``dataset`` (``eval/depthgen.run_forward``, one view
    per batch), then the filter's work for each view (``eval/scene_filter.
    fuse_view``, as ``filter_scene`` runs it) against the first
    ``nview_filter - 1`` source views of its entry in ``dataset.pairs``, all
    on ``device``; with ``ply_path`` the cloud is written there
    (``write_ply``). Returns the per-view depths, final masks and point
    counts, the fused points, and the host seconds per view of the forward
    and of the filter (each ending in results on the host). ``forward``:
    the eval forward to run, by default a new ``make_eval_forward(model)``
    (on the card its first view captures the graph)."""
    from .data.loader import collate
    from .eval.depthgen import make_eval_forward, run_forward
    from .eval.ply import write_ply
    from .eval.scene_filter import fuse_view

    forward = forward or make_eval_forward(model)
    depths, confs, cams, images, fwd_s = {}, {}, {}, {}, []
    for i, (v, _) in enumerate(dataset.pairs):
        sample = dataset[i]
        out, seconds, _ = run_forward(forward, collate([sample]), device)
        fwd_s.append(seconds)
        depths[v], confs[v] = out["depth"][0], out["confidence"][0]
        ref_cam = sample["proj_matrices"]["stage4"][0]
        cams[v] = (ref_cam[1, :3, :3], ref_cam[0])
        images[v] = sample["imgs"][0]
    masks, counts, xyzs, rgbs, filt_s = {}, {}, [], [], []
    for v, srcs in dataset.pairs:
        t0 = time.perf_counter()
        res = fuse_view(v, srcs[: nview_filter - 1], depths, confs, cams, images, cfg,
                        device=device)
        filt_s.append(time.perf_counter() - t0)
        masks[v], counts[v] = res["final_mask"], len(res["xyz"])
        xyzs.append(res["xyz"])
        rgbs.append(res["rgb"])
    points = np.concatenate(xyzs)
    if ply_path is not None:
        write_ply(ply_path, points, np.concatenate(rgbs))
    return {"depths": depths, "final_masks": masks, "point_counts": counts, "points": points,
            "forward_s": fwd_s, "filter_s": filt_s}


def compare_pipelines(cpu: Dict, dev: Dict, what: str = "device") -> Dict[str, object]:
    """Hold run ``dev`` of ``run_pipeline`` to run ``cpu``: per view, the
    depth equal (rtol 1e-5) at ``PIPELINE_DEPTH_AGREEMENT`` of the pixels
    and the final mask at ``PIPELINE_MASK_AGREEMENT``; the fused point count
    within ``PIPELINE_POINTS_RTOL``."""
    worst_depth = worst_mask = 1.0
    for v, want in cpu["depths"].items():
        same = np.isclose(dev["depths"][v], want, rtol=1e-5, atol=0).mean()
        agree = (dev["final_masks"][v] == cpu["final_masks"][v]).mean()
        worst_depth, worst_mask = min(worst_depth, same), min(worst_mask, agree)
        if same < PIPELINE_DEPTH_AGREEMENT or agree < PIPELINE_MASK_AGREEMENT:
            raise AssertionError(f"pipeline view {v} on {what}: depth agreement {same}, "
                                 f"final-mask agreement {agree}")
    n_cpu, n_dev = len(cpu["points"]), len(dev["points"])
    if abs(n_dev - n_cpu) > PIPELINE_POINTS_RTOL * n_cpu:
        raise AssertionError(f"pipeline on {what}: {n_dev} fused points, cpu {n_cpu}")
    return {"depth_agreement_min": float(worst_depth), "final_mask_agreement_min":
            float(worst_mask), "points_device": n_dev, "points_cpu": n_cpu}


def check_pipeline(device) -> Dict[str, object]:
    """``run_pipeline`` of the scripts/eval_dtu.sh model (float32, weights
    from ``PIPELINE_CHECK_SEED``) on a ``SyntheticEvalDataset`` of
    ``PIPELINE_CHECK_VIEWS`` views at ``PIPELINE_CHECK_HW``, on ``device``
    (set up as the eval CLI sets it up, ``config.setup_device``) against the
    CPU, held by ``compare_pipelines``."""
    from .data.synthetic import SyntheticEvalDataset

    device = setup_device(device)
    ds = SyntheticEvalDataset(V=PIPELINE_CHECK_VIEWS, H=PIPELINE_CHECK_HW[0],
                              W=PIPELINE_CHECK_HW[1])
    cfg = eval_dtu_config()
    cpu = run_pipeline(seeded_model(cfg, PIPELINE_CHECK_SEED, "cpu"), ds, "cpu")
    dev = run_pipeline(seeded_model(cfg, PIPELINE_CHECK_SEED, device), ds, device)
    return compare_pipelines(cpu, dev, str(device))


# ------------------------------------------------- the row-sharded eval --

# windowed against unsharded, float32: the JAX package's own limits
# (tests/test_spatial_sharding.py): the depth isclose(rtol 1e-4, atol
# 1e-2) and the confidence isclose(rtol 1e-3, atol 1e-3) on at least 99.5%
# of the pixels (an argmax near-tie may flip where the windows' convolutions
# sum in another order). bf16 is held statistically: the median |depth
# difference| within 0.5% of the depth range, every depth finite
SPACE_DEPTH_TOL = (1e-4, 1e-2)
SPACE_CONF_TOL = (1e-3, 1e-3)
SPACE_AGREEMENT = 0.995
SPACE_BF16_MEDIAN = 0.005


def compare_space(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], dtype,
                  depth_range: float, what: str = "space") -> Dict[str, object]:
    """Hold the stage outputs ``got`` of a row-sharded forward to the
    unsharded ``want`` (``{"stage{i}": {"depth", "photometric_confidence",
    ...}}``): every stage's depth and the last stage's confidence, at the
    limits above for ``dtype``; in either dtype the confidence finite (or
    not) at the same pixels but for ``1 - SPACE_AGREEMENT`` of them.
    Returns the agreements per stage."""
    out: Dict[str, object] = {}
    last = sorted(want)[-1]
    for key in sorted(want):
        g, w = got[key]["depth"].float().cpu(), want[key]["depth"].float().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what} {key}: depth {tuple(g.shape)} not finite/shaped")
        agree = torch.isclose(g, w, rtol=SPACE_DEPTH_TOL[0],
                              atol=SPACE_DEPTH_TOL[1]).float().mean().item()
        median = (g - w).abs().median().item()
        row = {"depth_agreement": agree, "depth_median_abs_diff": median}
        if dtype == torch.float32 and agree < SPACE_AGREEMENT:
            raise AssertionError(f"{what} {key}: depth agreement {agree}")
        if dtype != torch.float32 and median > SPACE_BF16_MEDIAN * depth_range:
            raise AssertionError(f"{what} {key}: median |depth diff| {median}")
        if key == last:
            gc = got[key]["photometric_confidence"].float().cpu()
            wc = want[key]["photometric_confidence"].float().cpu()
            # over every pixel: one finite and one not disagree, in any dtype
            conf = torch.isclose(gc, wc, rtol=SPACE_CONF_TOL[0], atol=SPACE_CONF_TOL[1],
                                 equal_nan=True).float().mean().item()
            mismatch = (torch.isfinite(gc) != torch.isfinite(wc)).float().mean().item()
            row["confidence_finite_mismatch"] = mismatch
            if mismatch > 1.0 - SPACE_AGREEMENT:
                raise AssertionError(f"{what} {key}: confidence finite at other pixels "
                                     f"({mismatch} of them)")
            row["confidence_agreement"] = conf
            if dtype == torch.float32 and conf < SPACE_AGREEMENT:
                raise AssertionError(f"{what} {key}: confidence agreement {conf}")
        out[key] = row
    return out


# ------------------------------------------------ the data-parallel step --

DDP_LR = 1e-3
DDP_WD = 1e-4
# the first step's loss and BatchNorm statistics, data-parallel against
# bare, relative to max(1, |value|): float32 rounding of another algorithm;
# the first update against Adam replayed on the step's own gradients
DDP_FIRST_STEP_RTOL = 1e-6
# bare runs from the same seed; their pairwise gaps are the step's
# run-to-run noise (on the card K3 sums with float32 atomics, whose order
# varies from run to run; on the CPU the step is deterministic: no noise)
DDP_BARE_RUNS = 4
# a data-parallel run's gap from the bare runs (its median gap to them)
# may be this multiple of the largest gap between two bare runs. A
# tensor's gradient may reach this multiple of its own noise or of the
# whole gradient's: a few tensors' gradients (the FPN's 1x1 weights in
# bf16) take one of a few values run to run, so four runs can all land on
# one of them
DDP_NOISE_MULT = 4.0
# a loss after the first update may besides be off by this share of what
# that update moved the bare loss: one scalar's spread over four runs is a
# poor estimate of its noise (they land close together by chance)
DDP_LOSS_FLOOR = 0.02
_BN_STATS = ("running_mean", "running_var")


def _params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}


def _ddp_run(make_model, batch, steps: int, dp_impl: Optional[str], device):
    """``steps`` recipe-loss Adam steps (lr ``DDP_LR``, wd ``DDP_WD``) of a
    fresh ``make_model()`` on ``batch``, bare or through ``data_parallel``:
    the losses; the parameters before and after the first step, the first
    step's gradients as the optimizer takes them (after DDP's reduction)
    and the BatchNorm statistics after it; the state after the last step;
    the host ms of each step (to its loss on the host). Tensors on the CPU
    in float32."""
    from .parallel.mesh import data_parallel
    from .train.step import make_optimizer, make_train_step

    model = make_model()
    optimizer = make_optimizer(model, DDP_WD)
    step = make_train_step(model, RECIPE_LOSS, optimizer, lambda i: DDP_LR)
    if dp_impl is not None:
        data_parallel(step, dp_impl, device=device)
    run: Dict[str, object] = {"params0": _params(model), "grads": {}, "losses": [], "ms": []}

    def first_grads(opt, args, kwargs):
        if not run["grads"]:
            run["grads"] = {n: (torch.zeros_like(p) if p.grad is None else p.grad).float().cpu()
                            for n, p in model.named_parameters()}

    def state():
        return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    hook = optimizer.register_step_pre_hook(first_grads)
    with graphs.eager():    # data-parallel steps are eager: so is the bare one here
        for i in range(steps):
            t0 = time.perf_counter()
            run["losses"].append(step(batch)["loss"].item())
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                run["params1"] = _params(model)
                run["first_bn"] = {k: v for k, v in state().items() if k.endswith(_BN_STATS)}
    hook.remove()
    run["last"] = state()
    return run


def _replayed_update(run: Dict, device) -> float:
    """The largest gap, relative to max(1, max|value|) of its tensor,
    between the parameters after ``run``'s first step and a fresh Adam step
    (``make_optimizer``, lr ``DDP_LR``) from its initial parameters on its
    own first gradients, on ``device``: the update is the one the
    gradients held above call for."""
    from .train.step import make_optimizer

    params = torch.nn.ParameterList(
        [torch.nn.Parameter(v.to(device)) for v in run["params0"].values()])
    optimizer = make_optimizer(params, DDP_WD)
    for group in optimizer.param_groups:
        group["lr"] = DDP_LR
    for p, name in zip(params, run["params0"]):
        p.grad = run["grads"][name].to(device)
    optimizer.step()
    return max(_max_rel(run["params1"][name], p.detach().cpu())
               for p, name in zip(params, run["params0"]))


def _rel_l2(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], names) -> float:
    """``||a - b|| / ||b||`` over the tensors ``names`` taken as one vector
    (``||a - b||`` where ``b`` is 0)."""
    num = sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in names)
    den = sum(float((b[n].double() ** 2).sum()) for n in names)
    return float(np.sqrt(num / den if den else num))


def _ddp_gaps(a: Dict, b: Dict) -> Dict[str, object]:
    """The gaps of run ``a`` from run ``b``: the first step's gradients
    (all of them, and each tensor's; the reg nets' ``prob.bias`` left out,
    as in ``grad_gaps``), the BatchNorm statistics and the parameters after
    the last step, each a relative L2 gap (``_rel_l2``); the losses after
    the first update, absolute."""
    names = [n for n in b["grads"] if not n.endswith("prob.bias")]
    stats = [k for k in b["last"] if k.endswith(_BN_STATS)]
    return {"grads": _rel_l2(a["grads"], b["grads"], names),
            "grad_tensors": {n: _rel_l2(a["grads"], b["grads"], [n]) for n in names},
            "bn_stats_last": _rel_l2(a["last"], b["last"], stats),
            "params_last": _rel_l2(a["last"], b["last"], list(b["grads"])),
            "losses": [abs(x - y) for x, y in zip(a["losses"][1:], b["losses"][1:])]}


def _gap_stat(gaps, reduce):
    """``reduce`` (max or median) over a list of ``_ddp_gaps``, leaf by
    leaf."""
    first = gaps[0]
    if isinstance(first, dict):
        return {k: _gap_stat([g[k] for g in gaps], reduce) for k in first}
    if isinstance(first, list):
        return [_gap_stat([g[i] for g in gaps], reduce) for i in range(len(first))]
    return float(reduce(gaps))


def check_ddp_step(device, make_model, batch, steps: int = 3,
                   dp_impls=("gspmd", "shard_map")) -> Dict[str, object]:
    """``steps`` train steps through ``data_parallel(step, dp_impl)`` for
    each of ``dp_impls``, on a world of one rank (the default process group
    must exist), against ``DDP_BARE_RUNS`` runs of the bare ``TrainStep``,
    each run from a fresh ``make_model()``. The bare runs' largest pairwise
    gap (``_ddp_gaps``) is the step's run-to-run noise; a data-parallel
    run's gap is its median gap to the bare runs. Each data-parallel run
    holds:

    - the first step's loss and the BatchNorm running statistics after it
      (the forward's work, before any update) within
      ``DDP_FIRST_STEP_RTOL`` of the first bare run's;
    - a nonzero gradient on every parameter (the ``prob.bias`` need none);
    - the first step's gradients, as the optimizer takes them after DDP's
      reduction, within ``DDP_NOISE_MULT`` times the noise: all of them
      together, and each tensor's (module constants). Where the step is
      deterministic that is bit for bit. A zeroed, lost, scaled or
      misplaced gradient breaks this, where Adam's update, about the
      learning rate whatever the gradient's size, would hide it;
    - the parameters after the first step within ``DDP_FIRST_STEP_RTOL`` of
      Adam replayed on those gradients (``_replayed_update``);
    - the BatchNorm statistics after the last step within
      ``DDP_NOISE_MULT`` times the noise;
    - each loss after the first update within ``DDP_NOISE_MULT`` times the
      bare runs' spread of that loss, or ``DDP_LOSS_FLOOR`` of what the
      first update moved the bare loss, whichever is larger, of the bare
      runs' median; every loss finite.

    The parameters after the last step are reported beside their noise, not
    held: Adam moves an entry whose gradient is near zero by about the
    learning rate either way, so their gap from run to run takes one of a
    few sizes, as many entries flip sign, and a multiple of four runs' gap
    would fail by chance; what moves them, the gradients and the update,
    is held above. Returns the noise, and per run its gaps, losses and the
    host ms per step after the first, beside the bare step's."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != 1:
        raise RuntimeError("check_ddp_step needs a default process group of one rank")
    bare = [_ddp_run(make_model, batch, steps, None, device) for _ in range(DDP_BARE_RUNS)]
    noise = _gap_stat([_ddp_gaps(a, b) for i, b in enumerate(bare) for a in bare[i + 1:]], max)
    bare_losses = np.array([r["losses"] for r in bare])
    centre = np.median(bare_losses, axis=0)
    floor = DDP_LOSS_FLOOR * abs(centre[1] - centre[0]) if steps > 1 else 0.0
    loss_limits = [max(DDP_NOISE_MULT * (hi - lo), floor)
                   for hi, lo in zip(bare_losses.max(0)[1:], bare_losses.min(0)[1:])]
    out = {"steps": steps, "bare_runs": DDP_BARE_RUNS, "noise_mult": DDP_NOISE_MULT,
           "noise": {k: v for k, v in noise.items() if k != "grad_tensors"},
           "bare_losses": bare_losses.tolist(), "loss_limits": loss_limits,
           "bare_ms_per_step": float(np.median([m for r in bare for m in r["ms"][1:]]
                                               or bare[0]["ms"])),
           "impls": []}
    for dp_impl in dp_impls:
        run = _ddp_run(make_model, batch, steps, dp_impl, device)
        what = f"data_parallel {dp_impl} on {device}"
        ref = bare[0]
        loss_gap = abs(run["losses"][0] - ref["losses"][0]) / max(1.0, abs(ref["losses"][0]))
        bn_gap = max((_max_rel(run["first_bn"][k], v) for k, v in ref["first_bn"].items()),
                     default=0.0)
        if loss_gap > DDP_FIRST_STEP_RTOL or bn_gap > DDP_FIRST_STEP_RTOL:
            raise AssertionError(f"{what}: first loss {run['losses'][0]} (bare "
                                 f"{ref['losses'][0]}), BatchNorm gap {bn_gap}")
        for name, g in run["grads"].items():
            if not name.endswith("prob.bias") and g.abs().max().item() == 0.0:
                raise AssertionError(f"{what}: no gradient on {name}")
        gap = _gap_stat([_ddp_gaps(run, b) for b in bare], np.median)
        for key in ("grads", "bn_stats_last"):
            if not gap[key] <= DDP_NOISE_MULT * noise[key]:
                raise AssertionError(f"{what}: {key} gap {gap[key]}, bare runs' {noise[key]}")
        limits = {n: DDP_NOISE_MULT * max(v, noise["grads"])
                  for n, v in noise["grad_tensors"].items()}

        def share(n):
            g, limit = gap["grad_tensors"][n], limits[n]
            return g / limit if limit else (float("inf") if g else 0.0)

        worst = max(limits, key=share)
        if share(worst) > 1.0:
            raise AssertionError(f"{what}: gradient of {worst} gap {gap['grad_tensors'][worst]}, "
                                 f"bare runs' {noise['grad_tensors'][worst]}")
        update_gap = _replayed_update(run, device)
        if update_gap > DDP_FIRST_STEP_RTOL:
            raise AssertionError(f"{what}: first update {update_gap} from Adam's on its gradients")
        off = np.abs(np.array(run["losses"][1:]) - centre[1:])
        if not np.isfinite(run["losses"]).all() or (off > loss_limits).any():
            raise AssertionError(f"{what}: losses {run['losses']}, bare {bare_losses.tolist()}, "
                                 f"limits {loss_limits}")
        out["impls"].append({
            "dp_impl": dp_impl, "losses": run["losses"],
            "first_loss_bit_equal": loss_gap == 0, "first_bn_stats_bit_equal": bn_gap == 0,
            "gaps": {k: v for k, v in gap.items() if k != "grad_tensors"},
            "worst_grad_tensor": {"name": worst, "gap": gap["grad_tensors"][worst],
                                  "noise": noise["grad_tensors"][worst],
                                  "limit": limits[worst], "share_of_limit": share(worst)},
            "first_update_vs_replayed_adam": update_gap,
            "loss_offsets": off.tolist(),
            "ms_per_step": float(np.median(run["ms"][1:] or run["ms"]))})
    return out


# --------------------------------------------------------- the debug dumps --

def compare_debug_dumps(got: Dict[str, str], want: Dict[str, str],
                        what: str = "device") -> Dict[str, object]:
    """Hold the debug dumps ``got`` (``{name: .npy path}`` of a device) to
    the CPU's ``want``: the same names and shapes, float32; an element
    agrees where it is within ``FORWARD_ATTN_ATOL`` of max(1, max|CPU
    array|). The input and the pyramid's feature maps (before any argmax)
    agree everywhere, every other array (the regularizers' maps among them)
    at ``PIPELINE_DEPTH_AGREEMENT`` of its
    elements (an argmax near-tie moves the next stage's hypotheses, and
    with them what the later stages compute at that pixel); the logits are
    held where the attention is above 1e-6."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"debug dumps on {what}: names {sorted(set(got) ^ set(want))}")
    worst = {"features": 1.0, "stages": 1.0}
    for name, path in want.items():
        w, g = np.load(path), np.load(got[name])
        if g.shape != w.shape or g.dtype != np.float32:
            raise AssertionError(f"debug {name} on {what}: {g.shape} {g.dtype}, cpu {w.shape}")
        if name.endswith("attn_logits"):
            keep = np.exp(w) > 1e-6
            g, w = g[keep], w[keep]
        tol = FORWARD_ATTN_ATOL * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
        share = float((np.abs(g - w) <= tol).mean()) if w.size else 1.0
        group = ("features" if name.startswith(("feat_", "input"))
                 and not name.startswith("feat_reg_stage") else "stages")
        need = 1.0 if group == "features" else PIPELINE_DEPTH_AGREEMENT
        if share < need:
            raise AssertionError(f"debug {name} on {what}: {share} of elements agree")
        worst[group] = min(worst[group], share)
    return {"arrays": len(want), "agreement_min": worst}


# ----------------------------------------------------- the captured paths --

# eager forwards whose agreement with each other bounds a replay's, where
# the eager forward itself varies from run to run (check_graph_forward)
GRAPH_EAGER_FORWARDS = 3
# eager runs of the train step from the same seed, whose gaps from each
# other are its run-to-run noise on the card (K3's float32 atomics); the
# replayed step's median gap to them may be DDP_NOISE_MULT times that, the
# rule of check_ddp_step
GRAPH_EAGER_RUNS = 4


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, so that equal means bit for bit (NaN and -0.0 too)."""
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _leaves(tree):
    return graphs.signature((tree,))[1]


def _tree_gap(got, want) -> Dict[str, object]:
    """Whether two output trees are equal bit for bit, and the largest
    absolute difference over their finite entries."""
    a, b = _leaves(got), _leaves(want)
    if [(t.shape, t.dtype) for t in a] != [(t.shape, t.dtype) for t in b]:
        raise AssertionError("the outputs differ in structure, shape or dtype")
    gap = 0.0
    for x, y in zip(a, b):
        both = torch.isfinite(x) & torch.isfinite(y)
        if both.any():
            gap = max(gap, (x.float() - y.float()).abs()[both].max().item())
    return {"bit_equal": all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b)),
            "max_abs_diff": gap}


def _agreement(got, want) -> float:
    """The share of output elements equal (rtol 1e-5, as ``check_forward``
    holds the card to the CPU; NaN equal to NaN) over two output trees."""
    pairs = list(zip(_leaves(got), _leaves(want)))
    same = sum(torch.isclose(x.float(), y.float(), rtol=1e-5, atol=0, equal_nan=True)
               .sum().item() for x, y in pairs)
    return same / sum(y.numel() for _, y in pairs)


@contextlib.contextmanager
def _cudnn_deterministic():
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flag


def check_graph_forward(model, imgs, projs, dv) -> Dict[str, object]:
    """``eval.depthgen.make_eval_forward(model)`` on the card, replayed,
    against the same forward run eagerly (``graphs.eager``) on the same
    inputs, in two settings:

    1. with cuDNN's deterministic algorithms
       (``torch.backends.cudnn.deterministic``), where the eager forward
       gives the same bits run after run: two replays bit-equal to the
       eager forward, and the first call's outputs unchanged across a later
       call on other inputs (a replay writes fresh tensors);
    2. as the port runs, cuDNN free to pick an algorithm whose sums run in
       an order that varies between runs (the float32 transposed
       convolutions of the regularizers run cuDNN's ``dgrad_engine``): the
       two replays' agreement with ``GRAPH_EAGER_FORWARDS`` eager runs (the
       share of output elements equal, ``_agreement``) at least the eager
       runs' own lowest agreement with each other, or
       ``FORWARD_DEPTH_AGREEMENT`` where that is lower; reported beside
       whether the replay is bit-equal.

    Returns the readings of both."""
    from .eval.depthgen import make_eval_forward

    args = (imgs, projs, dv)
    with _cudnn_deterministic():
        forward = make_eval_forward(model)
        with graphs.eager():
            want = forward(*args)
            eager_gap = _tree_gap(forward(*args), want)
        got = forward(*args)                          # captures, then replays
        kept = [t.clone() for t in _leaves(got)]
        replay = _tree_gap(forward(*args), want)
        forward(imgs * 0.5, projs, dv)                # a later call, other inputs
        torch.cuda.synchronize()
        first = _tree_gap(got, want)
        if not (eager_gap["bit_equal"] and first["bit_equal"] and replay["bit_equal"]):
            raise AssertionError(f"deterministic cuDNN: eager against eager {eager_gap}, "
                                 f"replays against eager {first}, {replay}")
        if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(_leaves(got), kept)):
            raise AssertionError("a later call overwrote an earlier call's outputs")
        graph_count = len(forward.graphs)
    del forward

    forward = make_eval_forward(model)
    with graphs.eager():
        eager = [forward(*args) for _ in range(GRAPH_EAGER_FORWARDS)]
    replays = [forward(*args) for _ in range(2)]
    eager_agree = min(_agreement(a, b) for i, b in enumerate(eager) for a in eager[i + 1:])
    agree = min(_agreement(r, e) for r in replays for e in eager)
    if agree < min(eager_agree, FORWARD_DEPTH_AGREEMENT):
        raise AssertionError(f"captured eval forward agrees with eager at {agree}, the eager "
                             f"runs with each other at {eager_agree}")
    return {"deterministic_cudnn": {"vs_eager": first, "second_replay_vs_eager": replay,
                                    "eager_vs_eager": eager_gap, "earlier_outputs_kept": True},
            "default": {"vs_eager": _tree_gap(replays[0], eager[0]),
                        "agreement_min": agree, "eager_agreement_min": eager_agree,
                        "eager_vs_eager": _tree_gap(eager[1], eager[0])},
            "graphs": graph_count}


def check_graph_eval_step(model, batch, loss_cfg: LossConfig = RECIPE_LOSS) -> Dict[str, object]:
    """``train.step.make_eval_step`` replayed against the same step run
    eagerly on ``batch``: every scalar bit for bit."""
    from .train.step import make_eval_step

    step = make_eval_step(model, loss_cfg)
    with graphs.eager():
        want = step(batch)
    step(batch)                                       # captures
    got = step(batch)                                 # replays
    gap = _tree_gap(got, want)
    if not gap["bit_equal"]:
        raise AssertionError(f"captured eval step against eager: {gap}")
    return {"scalars": len(want), "bit_equal": True,
            "loss": float(got["loss"]), "graphs": len(step.graphs)}


def _graph_train_run(make_model, batch, steps: int, captured: bool) -> Dict[str, object]:
    """``steps`` recipe-loss Adam steps (lr ``DDP_LR``, wd ``DDP_WD``) of a
    fresh ``make_model()`` on ``batch``, captured or eager: the losses; the
    gradients that ``.grad`` holds after the first call (the step's
    contract) and the state after the last; the host ms of each step."""
    from .train.step import make_optimizer, make_train_step

    model = make_model()
    step = make_train_step(model, RECIPE_LOSS, make_optimizer(model, DDP_WD),
                           lambda i: DDP_LR)
    run: Dict[str, object] = {"losses": [], "ms": []}
    with (graphs.eager() if not captured else contextlib.nullcontext()):
        for i in range(steps):
            t0 = time.perf_counter()
            run["losses"].append(step(batch)["loss"].item())
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                run["grads"] = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
                                .float().cpu() for n, p in model.named_parameters()}
    run["last"] = {k: v.detach().float().cpu() for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
    run["graphs"] = len(step._captured.graphs)
    return run


def check_graph_train_step(make_model, batch, steps: int = 3) -> Dict[str, object]:
    """The captured train step (``train.step.TrainStep`` on the card)
    against ``GRAPH_EAGER_RUNS`` eager runs from the same seed, ``steps``
    steps each, all with cuDNN's deterministic algorithms, so that the
    noise is K3's atomics' alone and a replay that took other cuDNN
    algorithms than the eager step would show, by the rule of
    ``check_ddp_step``: the first loss within
    ``DDP_FIRST_STEP_RTOL``; the first step's gradients (as ``.grad``
    holds them after the call) and the BatchNorm statistics after the last
    step within ``DDP_NOISE_MULT`` times the eager runs' largest pairwise
    gap, all together and each gradient tensor; each later loss within
    ``DDP_NOISE_MULT`` times the eager runs' spread or ``DDP_LOSS_FLOOR``
    of what the first update moved it. Returns the noise, the gaps and the
    host ms per step after the first, captured and eager."""
    with _cudnn_deterministic():
        eager = [_graph_train_run(make_model, batch, steps, False)
                 for _ in range(GRAPH_EAGER_RUNS)]
        run = _graph_train_run(make_model, batch, steps, True)
    noise = _gap_stat([_ddp_gaps(a, b) for i, b in enumerate(eager) for a in eager[i + 1:]],
                      max)
    if run["graphs"] != 1:
        raise AssertionError(f"the train step captured {run['graphs']} graphs, want 1")
    gap = _gap_stat([_ddp_gaps(run, b) for b in eager], np.median)
    ref = eager[0]["losses"][0]
    first = abs(run["losses"][0] - ref) / max(1.0, abs(ref))
    if first > DDP_FIRST_STEP_RTOL:
        raise AssertionError(f"captured train step: first loss {run['losses'][0]}, eager {ref}")
    for key in ("grads", "bn_stats_last"):
        if not gap[key] <= DDP_NOISE_MULT * noise[key]:
            raise AssertionError(f"captured train step: {key} gap {gap[key]}, eager runs' "
                                 f"{noise[key]}")
    worst = max(noise["grad_tensors"], key=lambda n: gap["grad_tensors"][n] / max(
        DDP_NOISE_MULT * max(noise["grad_tensors"][n], noise["grads"]), 1e-30))
    limit = DDP_NOISE_MULT * max(noise["grad_tensors"][worst], noise["grads"])
    if gap["grad_tensors"][worst] > limit:
        raise AssertionError(f"captured train step: gradient of {worst} gap "
                             f"{gap['grad_tensors'][worst]}, limit {limit}")
    losses = np.array([r["losses"] for r in eager])
    centre = np.median(losses, axis=0)
    floor = DDP_LOSS_FLOOR * abs(centre[1] - centre[0]) if steps > 1 else 0.0
    limits = [max(DDP_NOISE_MULT * (hi - lo), floor)
              for hi, lo in zip(losses.max(0)[1:], losses.min(0)[1:])]
    off = np.abs(np.array(run["losses"][1:]) - centre[1:])
    if not np.isfinite(run["losses"]).all() or (off > limits).any():
        raise AssertionError(f"captured train step: losses {run['losses']}, eager "
                             f"{losses.tolist()}, limits {limits}")
    return {"steps": steps, "eager_runs": GRAPH_EAGER_RUNS, "noise_mult": DDP_NOISE_MULT,
            "noise": {k: v for k, v in noise.items() if k != "grad_tensors"},
            "gaps": {k: v for k, v in gap.items() if k != "grad_tensors"},
            "first_loss_bit_equal": run["losses"][0] == ref,
            "worst_grad_tensor": {"name": worst, "gap": gap["grad_tensors"][worst],
                                  "limit": limit},
            "losses": run["losses"], "eager_losses": losses.tolist(), "loss_limits": limits,
            "ms_per_step": float(np.median(run["ms"][1:] or run["ms"])),
            "eager_ms_per_step": float(np.median([m for r in eager for m in r["ms"][1:]]
                                                 or eager[0]["ms"]))}


def main() -> None:
    """Print the CPU's rounding noise in the train-step comparison, one
    JSON line per (seed, perturbation, draw)."""
    for seed in (3, 0, 4):
        for perturb in (1e-7, 1e-6):
            for draw in (1, 2):
                print(json.dumps(rounding_noise(seed, perturb, draw)), flush=True)


if __name__ == "__main__":
    main()
