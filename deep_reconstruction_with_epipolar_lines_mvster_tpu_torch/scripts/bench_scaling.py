"""Train throughput at 1, 2, 4, ... ranks and its scaling efficiency.

Counterpart of the JAX repo's ``scripts/bench_scaling.py``: the DTU recipe
model in bf16 with mono (``graft_entry.dtu_model_config``), its loss
(``checks.RECIPE_LOSS``: inverse depth, mono, l1_lw 0.003, 3 Sinkhorn
iterations), Adam at lr 1e-3 and weight decay 1e-4, ``per_rank_batch``
plane scenes a rank (the global batch ``make_plane_scene(seed=i)`` for i
< ranks x per_rank_batch, each rank its contiguous share). For each world
size n in 1, 2, 4, 8, ... up to the cards present (or, with ``--device
cpu``, up to ``--world`` gloo ranks), ``torchrun --standalone`` starts n
ranks; each joins the group (``parallel.distributed.init_distributed``:
NCCL on the cards, gloo on the CPU) and trains through
``parallel.mesh.data_parallel`` (``gspmd``): one warm-up step, then 5 timed
steps, the time on rank 0's host clock around work that ends in a
device synchronize. On the cards the step is a captured CUDA graph: the
warm-up step is its first call (``train.step.DDP_WARMUP_STEPS`` eager
steps, then the capture and one replay), the timed steps replay it.

Printed per world size: a ``setup`` line (rank 0's seconds for the process
group, the kernels' build (a no-op when the libraries are current), the
model build, the DDP wrap, the first step, the first step's first forward
(on the cards, the first eager warm-up step's), and the second step, the
first timed one), then one row with the JAX keys
``devices``, ``global_batch``, ``step_s``, ``samples_per_s`` and
``scaling_efficiency`` (samples/s over n x the one-rank rate).

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.scripts.bench_scaling [H W V per_rank_batch] [--device cpu --world N]

(defaults 512 640 5 2). Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..checks import RECIPE_LOSS
from ..config import resolve_device
from ..graft_entry import dtu_model_config
from ..parallel.distributed import run_torchrun

PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
TIMED_STEPS = 5
RUN_TIMEOUT_S = 1800


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(H: int, W: int, V: int, per_rank: int, device_kind: str) -> None:
    """One rank of one world size, started by ``torchrun``."""
    import torch.distributed as dist

    from ..data.synthetic import batch_samples, batch_to_torch, make_plane_scene
    from ..models import MVS4Net
    from ..ops import _build
    from ..parallel.distributed import init_distributed
    from ..parallel.mesh import data_parallel, split_batch
    from ..train.schedule import warmup_multistep
    from ..train.step import make_optimizer, make_train_step

    marks = [("start", time.perf_counter())]

    def mark(name):
        _sync(dev)
        marks.append((name, time.perf_counter()))

    mesh = init_distributed(device_kind)
    dev = mesh.device(device_kind)
    mark("process_group_s")
    if device_kind == "cuda":
        _build.build(_build.KERNELS)
    mark("kernel_build_s")
    n, B = mesh.world, per_rank * mesh.world
    batch = batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i) for i in range(B)])
    batch = batch_to_torch(split_batch(batch, mesh.rank, n), dev)
    model = MVS4Net(dtu_model_config(), device=dev, generator=torch.Generator().manual_seed(0))
    mark("model_build_s")
    step = data_parallel(make_train_step(model, RECIPE_LOSS, make_optimizer(model, 1e-4),
                                         warmup_multistep(1e-3, [100_000], 0.5)),
                         "gspmd", device=dev)
    mark("ddp_wrap_s")

    def first_forward(*_):
        # once: a later forward may be under capture, which a sync would break
        first.remove()
        mark("first_step_forward_s")

    first = model.register_forward_hook(first_forward)
    try:
        losses = [step(batch)["loss"]]
        mark("first_step_s")
    finally:
        first.remove()
    t0 = time.perf_counter()
    losses.append(step(batch)["loss"])
    mark("second_step_s")
    losses += [step(batch)["loss"] for _ in range(TIMED_STEPS - 1)]
    _sync(dev)
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    losses = [float(x) for x in losses]
    dist.destroy_process_group()
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise RuntimeError(f"non-finite train loss: {losses}")
    if mesh.rank == 0:
        # each mark's seconds since the one before ("first_step_s": the rest
        # of the step after its forward)
        split = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
        split["first_step_s"] += split["first_step_forward_s"]
        print(json.dumps({"setup": {"devices": n, **split}}), flush=True)
        print(json.dumps({"devices": n, "global_batch": B, "step_s": step_s,
                          "samples_per_s": B / step_s, "losses": losses}), flush=True)


def world_sizes(limit: int):
    n, out = 1, []
    while n <= limit:
        out.append(n)
        n *= 2
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="train samples/s and scaling efficiency over ranks")
    p.add_argument("shape", type=int, nargs="*", help="H W V per_rank_batch (512 640 5 2)")
    p.add_argument("--device", default=None, help="cpu: gloo ranks on the CPU")
    p.add_argument("--world", type=int, default=2, help="most ranks on the CPU")
    p.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    H, W, V, per_rank = (a.shape + [512, 640, 5, 2][len(a.shape):])[:4]
    kind = resolve_device(a.device).type
    if a.rank_worker:
        _rank(H, W, V, per_rank, kind)
        return []
    limit = torch.cuda.device_count() if kind == "cuda" else a.world
    rows, base = [], None
    for n in world_sizes(limit):
        out = run_torchrun(f"{PKG}.scripts.bench_scaling",
                           [str(H), str(W), str(V), str(per_rank), "--device", kind,
                            "--rank-worker"], n, RUN_TIMEOUT_S)
        lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        setup = [x for x in lines if "setup" in x]
        row = [x for x in lines if "step_s" in x]
        if len(setup) != 1 or len(row) != 1:
            raise RuntimeError(f"{n} ranks printed no result:\n{out[-4000:]}")
        row = row[0]
        base = base or row["samples_per_s"]
        row["scaling_efficiency"] = row["samples_per_s"] / (base * n)
        print(json.dumps(setup[0]), flush=True)
        print(json.dumps({k: row[k] for k in ("devices", "global_batch", "step_s",
                                               "samples_per_s", "scaling_efficiency")}),
              flush=True)
        rows.append({**row, **setup[0]})
    return rows


if __name__ == "__main__":
    main()
