"""The port's mesh entry points as captured CUDA graphs, on the CPU.

The JAX package jits its mesh steps and its sharded eval forward; the port
captures them on the card (``utils/graphs.py``): the data-parallel train
step (``TrainStep`` with ``dp``), the grouped eval step and
``parallel.mesh.sharded_eval_forward`` (a ``graphs.Lockstep``, one graph
per rank per round). The CPU has no graphs, so it checks what capture
needs of the code:

- the capture guard of ``tests/test_torch_port_graphs.py`` over a call
  after the warm-up: no host read of a tensor and no tensor built from
  host data in the data-parallel train step (a gloo world of one, both
  ``dp_impl`` forms, ``gspmd`` with a one-rank group so that its
  all-reduces run), the grouped eval step, and the sharded forward over
  ``["cpu"] * 2`` at ``space`` 1 and 2;
- the train step's warm-up under ``dp``: ``DDP_WARMUP_STEPS`` eager steps,
  after which the parameters, buffers and Adam state are as they were, so
  that a call takes one step;
- the lockstep's rounds: the order in which the sharded forward calls its
  segments, and the segments each captured round waits for.

The card's tests are in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import pytest
import torch
import torch.distributed as dist
from test_torch_port_graphs import CaptureGuard

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.parallel.mesh import (
    data_parallel,
    sharded_eval_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import step as step_mod
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils import graphs


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    # many small CPU operators: OpenMP barriers stall under the parallel run
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this one rank (a ``file://`` store)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch(B=1, V=3, H=64, W=64):
    return batch_to_torch(batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i)
                                         for i in range(B)]), "cpu")


def _dp_step(dp_impl: str):
    """The small float32 flagship's train step through ``data_parallel``;
    under ``gspmd`` with a one-rank group (``checks._one_rank_group``)."""
    model = checks.small_step_model(3)
    step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    data_parallel(step, dp_impl, device="cpu")
    if dp_impl == "gspmd":
        checks._one_rank_group(step)
    return step


# ------------------------------------------------------ the capture guard --

@pytest.mark.parametrize("dp_impl", ["gspmd", "shard_map"])
def test_data_parallel_step_reads_nothing_on_the_host(world_of_one, dp_impl):
    """After the capture's warm-up (``TrainStep._warm_up``: the eager steps
    in which DDP rebuilds its buckets and times its first iterations), a
    data-parallel call makes no host read of a tensor and builds no tensor
    from host data; under ``gspmd`` its BatchNorm and loss all-reduces run
    in that call. The CPU's Adam update is left out, as in
    ``test_captured_paths_read_nothing_on_the_host``: on the card the
    capturable Adam reads nothing on the host."""
    batch = _batch()
    step = _dp_step(dp_impl)
    step.model.train()
    step._warm_up(batch)
    with CaptureGuard() as guard, \
            mock.patch.object(dist, "all_reduce", wraps=dist.all_reduce) as all_reduce:
        step.optimizer.step = guard.paused(step.optimizer.step)
        step(batch)
    assert guard.seen == []
    assert (all_reduce.call_count > 0) == (dp_impl == "gspmd")


def test_grouped_eval_step_reads_nothing_on_the_host(world_of_one):
    """The eval step over a one-rank group (its masked means, metrics and
    scalars reduced over the group), with and without a ``valid`` mask:
    a second call makes no host read and builds no tensor from host data,
    and its all-reduces run."""
    batch = _batch(B=2)
    step = make_eval_step(checks.seeded_model(checks.small_step_model(3).cfg, 1, "cpu"),
                          checks.RECIPE_LOSS, group=dist.new_group())
    for b in (batch, {**batch, "valid": torch.tensor([1.0, 0.0])}):
        step(b)
        with CaptureGuard() as guard, \
                mock.patch.object(dist, "all_reduce", wraps=dist.all_reduce) as all_reduce:
            step(b)
        assert guard.seen == [] and all_reduce.call_count > 0


def _space_model():
    cfg = ModelConfig(group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
                      attn_temp=2.0, dtype="float32")
    return checks.seeded_model(cfg, 1, "cpu")


@pytest.mark.parametrize("space", [1, 2])
def test_sharded_eval_forward_reads_nothing_on_the_host(space):
    """``sharded_eval_forward`` over ``["cpu"] * 2`` (``space`` 1: two data
    shards of a B2 batch; ``space`` 2: two row windows of stage 4 at
    128x64, halo 16): a second call makes no host read and builds no
    tensor from host data."""
    b = _batch(B=2 // space, H=128, W=64)
    forward = sharded_eval_forward(_space_model(), ["cpu"] * 2, space=space, space_halo=16)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    forward(*args)
    with CaptureGuard() as guard:
        forward(*args)
    assert guard.seen == []


# ------------------------------------------------------------- the warm-up --

def _snapshot(step):
    with torch.no_grad():
        return ([t.clone() for t in step.model.parameters()],
                [t.clone() for t in step.model.buffers()],
                {id(p): {k: v.clone() for k, v in st.items()}
                 for p, st in step.optimizer.state.items()})


def _assert_same(got, want):
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    assert got[2].keys() == want[2].keys()
    for p, st in want[2].items():
        assert all(torch.equal(got[2][p][k], v) for k, v in st.items())


def test_warm_up_under_dp_restores_the_state_and_a_call_takes_one_step(world_of_one):
    """``TrainStep._warm_up`` under ``dp`` (``gspmd`` with a one-rank
    group) runs ``DDP_WARMUP_STEPS`` eager steps, then puts the parameters,
    buffers and Adam state back bit for bit: on a fresh step the moments
    and step counts it made are zero, and a following call equals one call
    of a step that had no warm-up, parameters, buffers and Adam state; a
    second warm-up after that call puts back the state after it."""
    batch = _batch()
    step, fresh = _dp_step("gspmd"), _dp_step("gspmd")
    forwards = []
    hook = step.model.register_forward_hook(lambda *_: forwards.append(1))
    step.model.train()
    before = _snapshot(step)
    step._warm_up(batch)
    hook.remove()
    assert len(forwards) == step_mod.DDP_WARMUP_STEPS
    after = _snapshot(step)
    _assert_same((after[0], after[1], {}), (before[0], before[1], {}))
    assert after[2] and all(not v.any() for st in after[2].values() for v in st.values())
    step(batch)
    fresh(batch)
    one = _snapshot(step)
    assert step.step == fresh.step == 1
    _assert_same((one[0], one[1], {}), _snapshot(fresh)[:2] + ({},))
    for (p, st), q in zip(step.optimizer.state.items(), fresh.optimizer.state):
        assert all(torch.equal(v, fresh.optimizer.state[q][k]) for k, v in st.items())
    step._warm_up(batch)
    _assert_same(_snapshot(step), one)


# ------------------------------------------------------------- the rounds --

@pytest.mark.parametrize("space", [1, 2])
def test_sharded_forward_rounds_and_their_order(space):
    """The sharded forward's segments, with a recording ``segment`` that
    runs each eagerly: round 0 on every rank, a round per windowed stage
    on every rank (stage 4 at 128x64, halo 16: one under ``space`` 2, none
    under 1), then the join on rank 0; the outputs equal the eager call's
    bit for bit. With the card's calls stubbed, ``graphs._Recorder`` puts
    each round after the round before on every other rank."""
    b = _batch(B=2 // space, H=128, W=64)
    args = (b["imgs"], b["proj_matrices"], b["depth_values"])
    forward = sharded_eval_forward(_space_model(), ["cpu"] * 2, space=space, space_halo=16)
    calls = []

    def segment(rank, device, fn):
        calls.append(rank)
        fn()

    got = forward.drive(segment, *args)
    want = forward(*args)
    assert all(torch.equal(got[s][k], want[s][k]) for s in want for k in want[s])
    rounds = {1: [0, 1, 0], 2: [0, 1, 0, 1, 0]}[space]
    assert calls == rounds

    stub = contextlib.nullcontext
    cuda = {"Stream": lambda *a, **k: object(), "graph_pool_handle": object,
            "CUDAGraph": object, "Event": object, "device": lambda d: stub(),
            "graph": lambda *a, **k: stub()}
    with contextlib.ExitStack() as stack:
        for name, fake in cuda.items():
            stack.enter_context(mock.patch.object(graphs.torch.cuda, name, fake))
        recorder = graphs._Recorder({})
        out = forward.drive(recorder.segment, *args)
    assert all(torch.equal(out[s][k], want[s][k]) for s in want for k in want[s])
    segs = recorder.segments
    assert [(s.rank, s.round) for s in segs] == [
        (r, sum(x == r for x in rounds[:i])) for i, r in enumerate(rounds)]
    for s in segs:
        assert {(a.rank, a.round) for a in s.after} == {
            (t.rank, t.round) for t in segs if t.rank != s.rank and t.round == s.round - 1}
    assert segs[-1].after and segs[0].stream is segs[2].stream
