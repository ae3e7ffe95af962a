"""Process-group runtime of the port.

Counterpart of the JAX package's ``parallel/distributed.py`` (reference
``train_mvs4.py:479-484``: env-var init, barrier, rank gating), for
processes that ``torchrun`` starts, one a card:

- ``init_distributed``: the process group from torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` (``nccl`` for the card, ``gloo`` for the
  CPU); a no-op in a process that no launcher started;
- ``host_mesh``: the layout of the ranks over hosts, and each rank's
  device (training shards the batch over every rank; the eval's
  ``(data, space)`` layout is ``mesh.sharded_eval_forward``'s device list);
- ``run_torchrun``: a module run on N ranks of this host by ``torchrun
  --standalone`` (the drivers' multi-rank runs);
- ``is_host0``: rank gating for logging and checkpoints;
- ``sync_hosts``: a barrier;
- ``mean_scalars``: the mean of a dict of 0-d tensors over the ranks
  (reference ``reduce_scalar_outputs``, ``utils.py:187-205``), and
  ``reduce_scalars_across_hosts``, the same for floats;
- ``all_reduce_sum`` and ``global_mean``: the differentiable sum over a
  process group and the global masked mean that the global-batch
  BatchNorm, the loss and the metrics use under ``dp_impl="gspmd"``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from typing import Dict, Optional

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def world_size(group=None) -> int:
    """Ranks of ``group`` (the default group), 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The ranks' layout: ``world`` ranks over ``world // local_world``
    hosts (``host`` is this rank's), this rank's ``rank`` and its
    ``local_rank`` within its host. Every rank is a data shard."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    host: int = 0

    @property
    def hosts(self) -> int:
        return self.world // self.local_world

    def device(self, kind: str = "cuda") -> torch.device:
        """This rank's device: ``cuda:local_rank`` on the card, else the CPU."""
        return torch.device(f"cuda:{self.local_rank}") if kind == "cuda" else torch.device("cpu")


def host_mesh() -> HostMesh:
    """The layout of this process from torchrun's environment (one process:
    rank 0 of 1)."""
    world = _env_int("WORLD_SIZE", 1)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if world % local_world:
        raise ValueError(f"world {world}, ranks per host {local_world}: uneven layout")
    return HostMesh(rank=_env_int("RANK", 0), world=world,
                    local_rank=_env_int("LOCAL_RANK", 0), local_world=local_world,
                    host=_env_int("GROUP_RANK", _env_int("RANK", 0) // local_world))


def init_distributed(device_kind: str = "cuda") -> HostMesh:
    """Join the process group that torchrun describes (``env://``; a
    launch of one process too): backend ``nccl`` for the card, after
    pinning this rank to ``cuda:LOCAL_RANK``, ``gloo`` for the CPU. A no-op
    in a process that no launcher started, or when the group exists
    already. Returns the layout (``host_mesh``)."""
    mesh = host_mesh()
    launched = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    if launched and not dist.is_initialized():
        if device_kind == "cuda":
            torch.cuda.set_device(mesh.local_rank)
        dist.init_process_group("nccl" if device_kind == "cuda" else "gloo",
                                init_method="env://", rank=mesh.rank, world_size=mesh.world)
    return mesh


def run_torchrun(module: str, args, nproc: int, timeout: float) -> str:
    """``torchrun --standalone --nproc_per_node nproc -m module args`` on
    this host, to its end; its standard output. Raises with the end of its
    output where it exits non-zero."""
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(nproc), "-m", module, *args],
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"torchrun of {module} on {nproc} ranks: rc {res.returncode}\n"
                           f"{(res.stdout + res.stderr)[-4000:]}")
    return res.stdout


def is_host0() -> bool:
    return rank() == 0


def sync_hosts() -> None:
    if world_size() > 1:
        dist.barrier()


def _collective_device(group=None) -> torch.device:
    """Where a collective's tensor must live: the current card under
    ``nccl``, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mean_tensors_across_ranks(tensors, group=None) -> None:
    """Replace each float tensor of ``tensors`` (on one device) by its mean
    over the ranks of ``group``, with one ``all_reduce``."""
    tensors = list(tensors)
    n = world_size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_scalars(scalars: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Each 0-d tensor's mean over the ranks of ``group`` (one
    ``all_reduce``), as new tensors; in one process the scalars as they
    are."""
    if world_size(group) == 1:
        return scalars
    keys = list(scalars)
    values = [scalars[k].detach().float().clone() for k in keys]
    mean_tensors_across_ranks(values, group)
    return dict(zip(keys, values))


def reduce_scalars_across_hosts(scalars: Dict[str, float], group=None) -> Dict[str, float]:
    """``mean_scalars`` of a dict of floats: each one's mean over the ranks,
    the same dict on every rank."""
    dev = _collective_device(group) if world_size(group) > 1 else torch.device("cpu")
    means = mean_scalars({k: torch.tensor(float(v), device=dev) for k, v in scalars.items()},
                         group)
    return {k: float(v) for k, v in means.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; its backward sums the cotangents the
    same way (every rank's loss depends on every rank's input through the
    sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable; ``x``
    itself when ``group`` is None."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def global_mean(num: torch.Tensor, den: torch.Tensor, group=None) -> torch.Tensor:
    """``num / max(den, 1)``; with ``group``, the global batch's: ``den``
    summed over the group's ranks, ``num`` scaled by their number, so that
    the ranks' mean of the result (and of its gradient) is the global sum
    over the global denominator."""
    if group is None:
        return num / den.clamp(min=1.0)
    den = all_reduce_sum(den.detach(), group)
    return num * world_size(group) / den.clamp(min=1.0)
