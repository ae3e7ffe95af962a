"""Driver ``train_steps``: training throughput of the captured DTU-recipe
train step.

Set-up builds the network with the seed's weights, the recipe's loss,
Adam with L2 weight decay and the warm-up schedule, and one
``train.step.TrainStep``; it renders the traffic mix's pool of ``pool``
host batches (images, cameras, per-stage depth and mask). Each step copies
its batch to the card as ``train/loop.fit`` does (``utils/graphs.to_device``
through ``data.synthetic.batch_to_torch``) and calls the step, captured on
its first call; the host reads nothing per step and runs at most two
steps ahead of the card. The first ``check_steps`` steps, on distinct
batches, are taken in set-up through the same call and feed, and their
losses, the first gradient as Adam holds it and the parameters after them
are kept; the same step object then runs the window.
``train_samples_per_s`` is the samples of every step of the window over
its seconds, the closing synchronise included.

After the window the plain reference takes the same steps from the same
weights on the same batches, in float32 (``compare.TrainGap``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import compare, harness, program
from benchmark.counts import roofline

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _host_batches(ctx, P, B, V):
    data = program.scenes(ctx, P * B, V, with_targets=True)

    def host(t, sl):
        return {k: host(v, sl) for k, v in t.items()} if isinstance(t, dict) \
            else t[sl].cpu().numpy()

    return [host(data, slice(i * B, (i + 1) * B)) for i in range(P)]


def _device_batch(batch, dev):
    def t(x):
        return {k: t(v) for k, v in x.items()} if isinstance(x, dict) \
            else torch.as_tensor(x, device=dev)
    return t(batch)


def _loss_terms(scalars):
    """The step's loss and its mono L1 terms (stages 2-4)."""
    return {"loss": scalars["loss"],
            "mono": scalars["s1_d_loss"] + scalars["s2_d_loss"] + scalars["s3_d_loss"]}


def run(ctx, fault=None):
    """One run of the cell (``run.py``); ``fault(step)`` (the benchmark's
    own tests) breaks the program's step object before its first call."""
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
        LossConfig,
        setup_device,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
        batch_to_torch,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.schedule import (
        warmup_multistep,
    )
    from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
        make_optimizer,
        make_train_step,
    )

    dev = setup_device(ctx.device)
    mix, spec, cfg = ctx.traffic, ctx.spec, ctx.config
    B, V, P = mix["batch"], mix["views"], mix["pool"]
    lc, oc = cfg["loss"], cfg["optimizer"]
    model, weights = program.build_model(cfg, ctx.seed, dev)
    loss_cfg = LossConfig(stage_lw=tuple(lc["stage_lw"]), l1_lw=lc["l1_lw"], ot_lw=lc["ot_lw"],
                          ot_iter=lc["ot_iter"], ot_eps=lc["ot_eps"],
                          inverse_depth=cfg["inverse_depth"], mono=cfg["mono"])
    schedule = warmup_multistep(oc["lr"], [10 ** 9], 0.5, warmup_factor=oc["warmup_factor"],
                                warmup_iters=oc["warmup_iters"])
    step = make_train_step(model, loss_cfg, make_optimizer(model, oc["weight_decay"]), schedule)
    if fault is not None:
        fault(step)
    batches = _host_batches(ctx, P, B, V)
    spans = harness.Spans()
    events = [None, None]
    n = 0

    def train_step():
        nonlocal n
        slot = n % 2
        if events[slot] is not None:
            events[slot].synchronize()
        with spans("step"):
            scalars = step(batch_to_torch(batches[n % P], dev))
        if dev.type == "cuda":
            events[slot] = torch.cuda.Event()
            events[slot].record()
        n += 1
        return scalars

    names = {id(p): k for k, p in model.named_parameters()}
    losses, first_grad = [], None
    for k in range(spec["check_steps"]):
        losses.append(_loss_terms(train_step()))
        if k == 0:
            b1 = step.optimizer.defaults["betas"][0]
            first_grad = {names[id(p)]: (st["exp_avg"] / (1 - b1)).clone()
                          for p, st in step.optimizer.state.items()}
    after = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses = [{k: float(v) for k, v in terms.items()} for terms in losses]
    spans = harness.Spans()
    win = harness.Window(ctx.seconds, dev)
    trace = {}
    n = 0
    win.open()
    setup_s = win.t0 - ctx.t_start
    while not win.done():
        if ctx.trace and not trace and time.perf_counter() - win.t0 >= ctx.seconds / 2:
            trace = harness.profile_stretch(train_step, spec["profile_iters"], spans, dev)
        else:
            train_step()
    elapsed = win.close()
    device = harness.device_info(dev)
    trace = harness.finish_trace(trace)

    got = {"losses": losses, "first_grad": first_grad, "after": after}
    del model, step, events
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    want = reference_steps(ctx, weights, batches[:spec["check_steps"]])
    gap = compare.TrainGap(weights, want)
    numbers = gap.numbers(got)
    checks = compare.judge(numbers, spec["limits"])
    failed = int(not all(np.isfinite(list(t.values())).all() for t in losses))
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    roof = roofline.totals(roofline.train_pieces(cfg, B, V, mix["height"], mix["width"]))
    kern = roofline.kernel_pieces(cfg, B, V, mix["height"], mix["width"], train=True)
    return {
        "e2e": {"train_samples_per_s": n * B / elapsed, "setup_s": setup_s},
        "attempted": n, "failed": failed, "correct": correct, "checks": checks,
        "numbers": numbers, "check_s": time.perf_counter() - t_check,
        "device": device, "trace": trace, "spans": dict(spans.total), "iters": n,
        "window_s": elapsed, "dtype": cfg["dtype"], "flops_per_iter": roof["flops"],
        "kernel_pieces": kern, "excluded_leaves": gap.excluded,
    }


def reference_steps(ctx, weights, batches, mode: str = "float32"):
    """The plain reference's steps from ``weights`` on ``batches``: each
    step's loss, the first step's gradient as Adam takes it (weight decay
    added), the parameters after the last step."""
    from benchmark.reference.mvster import Net, adam_step, recipe_loss, warmup_lr

    dev = torch.device(ctx.device)
    cfg = ctx.config
    lc, oc = cfg["loss"], cfg["optimizer"]
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()
              if k.rsplit(".", 1)[-1] not in BUFFERS}
    buffers = {k: v for k, v in weights.items() if k.rsplit(".", 1)[-1] in BUFFERS}
    state, losses, first_grad = {}, [], None
    for k, batch in enumerate(batches):
        b = _device_batch(batch, dev)
        net = Net({**params, **buffers}, cfg, train=True,
                  precision="fp8" if mode == "fp8" else "float32")
        with compare.precision(mode):
            out = net.forward(b["imgs"], b["proj_matrices"], b["depth_values"])
            loss, terms = recipe_loss(out, b["depth"], b["mask"], lc["l1_lw"], lc["ot_lw"],
                                      lc["ot_iter"])
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for (n, p), g in zip(params.items(), grads)}
        if k == 0:
            first_grad = {n: (g + oc["weight_decay"] * params[n]).detach().clone()
                          for n, g in grads.items()}
        with torch.no_grad():
            adam_step(params, grads, state, warmup_lr(oc["lr"], k, oc["warmup_iters"],
                                                      oc["warmup_factor"]),
                      oc["weight_decay"], k + 1, tuple(oc["betas"]), oc["eps"])
        terms = _loss_terms({**terms, "loss": loss})
        losses.append({k: float(v.detach()) if torch.is_tensor(v) else float(v)
                       for k, v in terms.items()})
        del out, loss, grads, terms
    return {"losses": losses, "first_grad": first_grad,
            "after": {k: v.detach() for k, v in params.items()}}


def control(ctx, mode: str):
    """The check's numbers with the reference at the control precision
    ``mode`` in the program's place."""
    dev = torch.device(ctx.device)
    mix = ctx.traffic
    _, weights = program.build_model(ctx.config, ctx.seed, dev)
    batches = _host_batches(ctx, mix["pool"], mix["batch"], mix["views"])[:ctx.spec["check_steps"]]
    low = reference_steps(ctx, weights, batches, mode)
    want = reference_steps(ctx, weights, batches)
    return compare.TrainGap(weights, want).numbers(low)
