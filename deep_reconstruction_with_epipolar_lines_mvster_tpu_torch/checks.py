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
"""

from __future__ import annotations

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

# parameters whose float32 gradient is ill-conditioned (see above)
ILL_CONDITIONED = ("feature.conv", "reg.")

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
                     base: int = 8, group_cor_dim=(8, 8, 4, 4)):
    """The flagship configuration in float32 on the CPU, weights drawn from
    ``seed``, at FPN base ``base`` and ``group_cor_dim``; ``perturb`` moves
    every weight by that relative amount (normal, from ``perturb_seed``)."""
    from .models import MVS4Net

    cfg = ModelConfig(group_cor=True, group_cor_dim=tuple(group_cor_dim), inverse_depth=True,
                      mono=True, attn_temp=2.0, dtype="float32", fpn_base_channel=base)
    model = MVS4Net(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
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

    seen: Dict[str, list] = {"hypo": [], "cuts": []}
    acts: Dict[str, torch.Tensor] = {}

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

    def keep(name, t):
        t.register_hook(lambda g: acts.__setitem__(name, g.detach().float().cpu()))

    hooks = [reg.register_forward_hook(lambda m, i, o: cut(i[0])) for reg in model.reg]
    hooks.append(model.mono_depth_decoder.register_forward_hook(
        lambda m, i, out: [cut(t) for t in out] and None))
    hooks.append(model.feature.register_forward_hook(
        lambda m, i, out: [keep(f"o{k + 1}", o) for k, o in enumerate(out)] and None))
    try:
        with mock.patch.object(net, "schedule_inverse_range",
                               pinned(net.schedule_inverse_range)), \
                mock.patch.object(net, "schedule_range", pinned(net.schedule_range)):
            step = make_train_step(model, RECIPE_LOSS, make_optimizer(model, 1e-4),
                                   lambda i: 1e-3)
            loss = step(batch)["loss"].item()
    finally:
        for h in hooks:
            h.remove()
    # a parameter that autograd never reached reads as a zero gradient
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()}
    return {"loss": loss, "grads": grads, "acts": acts, "seen": seen}


def grad_gaps(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per tensor ``max|got - want| / max|want|``. The reg nets'
    ``prob.bias`` are left out: their gradient is analytically zero (the
    softmax over D ignores a constant added to every score)."""
    return {n: ((got[n] - w).abs().max() / w.abs().max()).item()
            for n, w in want.items() if not n.endswith("prob.bias")}


def train_step_gaps(cpu: Dict, dev: Dict) -> Dict[str, Dict[str, float]]:
    """The gaps of run ``dev`` from run ``cpu``, by group: ``acts`` (the
    FPN outputs' gradients), ``kernel_fed`` (the top-down chain's and the
    mono decoder's parameters), ``ill`` (the stem's and the Reg2D nets')."""
    gaps = grad_gaps(cpu["grads"], dev["grads"])
    return {
        "acts": grad_gaps(cpu["acts"], dev["acts"]),
        "kernel_fed": {n: v for n, v in gaps.items() if not n.startswith(ILL_CONDITIONED)},
        "ill": {n: v for n, v in gaps.items() if n.startswith(ILL_CONDITIONED)},
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


def check_train_step(device, seed: int = 3, base: int = 8,
                     group_cor_dim=(8, 8, 4, 4)) -> Dict[str, object]:
    """One float32 train step of ``small_step_model(seed, base=base,
    group_cor_dim=group_cor_dim)`` on ``small_step_batch`` on ``device``,
    pinned to the same step on the CPU and held to it by
    ``compare_train_step``; ``device`` is set up by ``config.setup_device``
    (TF32 off)."""
    device = setup_device(device)
    kw = {"base": base, "group_cor_dim": group_cor_dim}
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
                  hw=(64, 128), views: int = 3) -> Dict[str, object]:
    """The float32 eval forward of the flagship model (group correlation,
    inverse depth, attn_temp 2, mono) at FPN base ``base`` and
    ``group_cor_dim``, weights and BatchNorm statistics from ``seed``
    (``seeded_model``), on a plane scene of ``views`` views at ``hw``, on
    ``device`` (``config.setup_device``) against the CPU: per stage the
    attention within ``FORWARD_ATTN_ATOL`` and the depth equal at
    ``FORWARD_DEPTH_AGREEMENT`` of the pixels."""
    from .data.synthetic import batch_samples, batch_to_torch, make_plane_scene

    device = setup_device(device)
    cfg = ModelConfig(group_cor=True, group_cor_dim=tuple(group_cor_dim), inverse_depth=True,
                      mono=True, attn_temp=2.0, dtype="float32", fpn_base_channel=base)
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
            raise AssertionError(f"base {base} {tuple(group_cor_dim)} stage{s} on {device}: "
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


def seeded_model(cfg: ModelConfig, seed: int, device):
    """``MVS4Net(cfg)`` with weights drawn from ``seed`` and its BatchNorm
    affine parameters and running statistics drawn away from identity (as
    a trained network's are), built on the CPU and moved to ``device``."""
    from .models import MVS4Net
    from .models.layers import TorchBatchNorm

    gen = torch.Generator().manual_seed(seed)
    model = MVS4Net(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
    return model.to(device)


def run_pipeline(model, dataset, device, cfg: FusionConfig = EVAL_DTU_FUSION,
                 nview_filter: int = 4, ply_path: Optional[str] = None) -> Dict[str, object]:
    """The eval CLI's path without its image files: the depth maps of every
    reference view of ``dataset`` (``eval/depthgen.run_forward``, one view
    per batch), then the filter's work for each view (``eval/scene_filter.
    fuse_view``, as ``filter_scene`` runs it) against the first
    ``nview_filter - 1`` source views of its entry in ``dataset.pairs``, all
    on ``device``; with ``ply_path`` the cloud is written there
    (``write_ply``). Returns the per-view depths, final masks and point
    counts, the fused points, and the host seconds per view of the forward
    and of the filter (each ending in results on the host)."""
    from .data.loader import collate
    from .eval.depthgen import make_eval_forward, run_forward
    from .eval.ply import write_ply
    from .eval.scene_filter import fuse_view

    forward = make_eval_forward(model)
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


def main() -> None:
    """Print the CPU's rounding noise in the train-step comparison, one
    JSON line per (seed, perturbation, draw)."""
    for seed in (3, 0, 4):
        for perturb in (1e-7, 1e-6):
            for draw in (1, 2):
                print(json.dumps(rounding_noise(seed, perturb, draw)), flush=True)


if __name__ == "__main__":
    main()
