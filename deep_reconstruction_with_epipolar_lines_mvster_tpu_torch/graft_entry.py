"""Driver entry points of the port: the flagship model, an example batch,
the eval forward as a function, and a multi-rank dry run.

Counterpart of the JAX repo's ``__graft_entry__.py``:

- ``dtu_model_config`` / ``dtu_model``: the flagship DTU-recipe model
  (``_dtu_model``, ``:8-49``): FPN, reg2d, group correlation (8,8,4,4),
  inverse depth, attn_temp 2, mono, bf16. The TPU layout flags it sets
  (``pack_conv``, ``warp_impl``, ``warp_band``, ``fused_topdown``) are kept
  so that the config reads as the JAX one; the port ignores them
  (``config.py``). Weights are drawn from a seeded generator.
- ``example_batch``: ``make_plane_scene(seed=seed + i)`` samples stacked
  into a batch of tensors (``_example_batch``, ``:52-64``).
- ``entry``: ``(fn, example_args)``, ``fn`` the eval forward returning the
  stage-4 depth and photometric confidence (``entry``, ``:103-122``). On
  the card it runs K1, K2, K5 and K6, captured in a CUDA graph on its
  first call and replayed after (``eval.depthgen.make_eval_forward``, as
  the JAX ``fn`` is jitted).
- ``dryrun_multichip(n)``: one train step of each data-parallel form over
  ``n`` ranks, and at ``n >= 2`` the row-sharded eval at halo 8 and the
  flagship at 256x320 with halo 48 (``:125-279``). The ranks are processes
  started by ``torchrun --standalone`` (NCCL on the cards, gloo on the
  CPU); the eval parts run on rank 0 over the ``(data, space=2)`` device
  list (``parallel.mesh.sharded_eval_forward``). On the cards both parts
  are captured CUDA graphs, as the port's mesh paths are: the train steps
  capture on their first call (after DDP's eager warm-up steps), the
  sharded forward one graph per rank per round; on the CPU they run
  eagerly.

Everything runs on the card unless the caller passes ``device="cpu"``;
without CUDA it raises. Unlike the JAX dry run, which moves to a virtual
CPU mesh when it finds too few devices, ``dryrun_multichip`` raises when
``n`` exceeds the cards present.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.graft_entry N [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict

import torch

from .config import LossConfig, ModelConfig, resolve_device
from .data.synthetic import batch_samples, batch_to_torch, make_plane_scene
from .eval.depthgen import make_eval_forward
from .models import MVS4Net
from .parallel.distributed import run_torchrun

PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
DRYRUN_TIMEOUT_S = 1800


def dtu_model_config(dtype: str = "bfloat16") -> ModelConfig:
    """The flagship DTU-recipe model's config (JAX ``_dtu_model().cfg``)."""
    return ModelConfig(
        group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
        mono=True, attn_temp=2.0, dtype=dtype, pack_conv=True,
        warp_impl="mxu_v3", warp_band=12, fused_topdown=True,
    )


def dtu_model(device=None, generator: torch.Generator | None = None) -> MVS4Net:
    """``MVS4Net(dtu_model_config())`` on ``device`` (the card unless
    given), weights from ``generator`` (seed 0 unless given), eval mode."""
    return MVS4Net(dtu_model_config(), device=device,
                   generator=generator or torch.Generator().manual_seed(0))


def example_batch(B: int = 1, V: int = 4, H: int = 256, W: int = 320, seed: int = 0,
                  device=None) -> Dict:
    """B plane scenes (``make_plane_scene(V, H, W, seed=seed + i)``)
    stacked and moved to ``device`` (``data.synthetic.batch_to_torch``)."""
    samples = [make_plane_scene(V=V, H=H, W=W, seed=seed + i) for i in range(B)]
    return batch_to_torch(batch_samples(samples), resolve_device(device))


def eval_fn(model):
    """``fn(imgs, proj_matrices, depth_values) -> (depth, confidence)``:
    ``model``'s eval forward as the eval CLI builds it
    (``eval.depthgen.make_eval_forward``: on the card a captured graph per
    input signature), stage 4's outputs."""
    forward = make_eval_forward(model)

    def fn(imgs, proj_matrices, depth_values):
        out = forward(imgs, proj_matrices, depth_values)
        return out["depth"], out["confidence"]

    return fn


def entry(device=None):
    """``(fn, example_args)``: the eval forward of the flagship model
    (``eval_fn(dtu_model(...))``) and ``example_batch()``'s model inputs."""
    dev = resolve_device(device)
    batch = example_batch(device=dev)
    return eval_fn(dtu_model(dev)), (
        batch["imgs"], batch["proj_matrices"], batch["depth_values"])


def _dryrun_config():
    """The dry run's model and loss (JAX ``dryrun_multichip``): the flagship
    widths in float32, the recipe loss without the Sinkhorn count."""
    cfg = ModelConfig(group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
                      mono=True)
    return cfg, LossConfig(inverse_depth=True, mono=True, l1_lw=0.003)


def _dryrun_rank(n: int, device_kind: str) -> None:
    """One rank of the dry run, started by ``torchrun``."""
    import torch.distributed as dist

    from .parallel.distributed import init_distributed
    from .parallel.mesh import DP_IMPLS, data_parallel, sharded_eval_forward, split_batch
    from .train.schedule import warmup_multistep
    from .train.step import make_optimizer, make_train_step

    mesh = init_distributed(device_kind)
    if mesh.world != n:
        raise RuntimeError(f"started {mesh.world} ranks for a dry run over {n}")
    dev = mesh.device(device_kind)
    cfg, lcfg = _dryrun_config()

    def model():
        return MVS4Net(cfg, device=dev, generator=torch.Generator().manual_seed(0))

    batch = example_batch(B=n, V=2, H=64, W=64, device=dev)
    losses = {}
    try:
        for impl in DP_IMPLS:
            m = model()
            step = data_parallel(make_train_step(m, lcfg, make_optimizer(m, 1e-4),
                                                 warmup_multistep(1e-3, [10_000], 0.5)),
                                 impl, device=dev)
            losses[impl] = float(step(split_batch(batch, mesh.rank, n))["loss"])
        if mesh.rank == 0 and n >= 2:
            # the (data, space=2) eval: halo 8 at the train shape, then the
            # flagship set at 256x320 with halo 48 (the execution flags the
            # JAX run turns on choose nothing in the port: same model)
            devices = [torch.device(device_kind, i) if device_kind == "cuda" else dev
                       for i in range(n)]
            m = model()
            for name, b, halo in (
                ("space_eval_rows", batch, 8),
                ("space_eval_flagship_kernels",
                 example_batch(B=max(2, n // 2), V=2, H=256, W=320, device=dev), 48),
            ):
                fn = sharded_eval_forward(m, devices, space=2, space_halo=halo)
                depth = fn(b["imgs"], b["proj_matrices"], b["depth_values"])["stage4"]["depth"]
                if not torch.isfinite(depth).all():
                    raise RuntimeError(f"non-finite depth in the dry run's {name}")
                losses[name] = float(depth.float().mean())
        bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"non-finite loss in the dry run: {bad}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if mesh.rank == 0:
        print(json.dumps({"dryrun_multichip": {"ranks": n, "device": device_kind, **losses}}),
              flush=True)


def dryrun_multichip(n: int, device=None) -> Dict[str, float]:
    """Run the dry run over ``n`` ranks (module docstring), print JAX's
    ``dryrun_multichip(n) ok: loss[...]=...`` line and return the losses.
    On the card ``n`` must not exceed ``torch.cuda.device_count()``."""
    kind = resolve_device(device).type
    if kind == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"need {n} cards, have {torch.cuda.device_count()}")
    out = run_torchrun(f"{PKG}.graft_entry", [str(n), "--device", kind, "--rank-worker"], n,
                       DRYRUN_TIMEOUT_S)
    found = [json.loads(line)["dryrun_multichip"] for line in out.splitlines()
             if line.startswith('{"dryrun_multichip"')]
    if len(found) != 1:
        raise RuntimeError(f"dry run printed no result:\n{out[-4000:]}")
    losses = {k: v for k, v in found[0].items() if k not in ("ranks", "device")}
    print(f"dryrun_multichip({n}) ok: "
          + " ".join(f"loss[{k}]={v:.4f}" for k, v in losses.items()), flush=True)
    return losses


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="multi-rank dry run of the port's train step "
                                            "and row-sharded eval")
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--device", default=None, help="cpu: gloo ranks on the CPU")
    p.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_worker:
        _dryrun_rank(args.n, args.device)
    else:
        dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
