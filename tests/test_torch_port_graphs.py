"""The port's counterpart of ``jax.jit`` (``utils/graphs.py``) on the CPU.

The CPU has no CUDA graphs: a captured function runs eagerly there. What
the CPU can show is what capture needs of the code and of the wrapper:

- the capture guard: after one warm-up call, a call of the eval forward,
  the eval step and a train step constructs no tensor from host data
  (``torch.tensor``, ``as_tensor``, ``from_numpy``) and reads no tensor's
  value on the host (``aten._local_scalar_dense`` and the ops that wait for
  a count, seen through a ``TorchDispatchMode``), for the flagship and each
  of ``checks.VARIANTS`` at a small size. On the card either would fail
  the capture;
- the cache key and the cache: one entry per signature;
- the train step's learning rate as a tensor: bit-equal to the step with a
  Python float;
- the tap tables of ``core/geometry.py``: cached, and bit-equal to the
  tables built per call;
- ``fit`` restores a checkpoint before its first step, which on the card
  captures, and a restore drops a step's graphs.

The card's tests of capture and replay are in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import checks
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.core import geometry
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.loader import DataLoader
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic import (
    SyntheticTrainDataset,
    batch_samples,
    batch_to_torch,
    make_plane_scene,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen import (
    make_eval_forward,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models.losses import mvs4net_loss
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train import loop
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.schedule import (
    warmup_multistep,
)
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step import (
    TrainStep,
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


def _batch(B=1, V=3, H=64, W=64):
    return batch_to_torch(batch_samples([make_plane_scene(V=V, H=H, W=W, seed=i)
                                         for i in range(B)]), "cpu")


# ------------------------------------------------------ the capture guard --

# the ops that read a tensor's value on the host (a scalar, or a count that
# sizes the output), and the op behind torch.tensor of host data
HOST_READS = ("_local_scalar_dense", "item", "nonzero", "masked_select", "equal",
              "is_nonzero", "unique", "_unique", "_unique2", "unique_consecutive",
              "unique_dim", "lift_fresh", "lift_fresh_copy")
# indexing ops whose boolean-mask index counts its entries on the host
MASK_INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")


class CaptureGuard(TorchDispatchMode):
    """Records every op of ``HOST_READS`` and every ``torch.tensor``,
    ``torch.as_tensor`` and ``torch.from_numpy`` call made while active;
    ``paused()`` suspends it."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self._patches = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if name in HOST_READS:
            self.seen.append(str(func))
        elif name in MASK_INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            self.seen.append(f"{func} with a boolean mask")
        return func(*args, **(kwargs or {}))

    def _wrap(self, name):
        real = getattr(torch, name)

        def constructor(*args, **kwargs):
            self.seen.append(f"torch.{name}")
            return real(*args, **kwargs)

        return mock.patch.object(torch, name, constructor)

    def __enter__(self):
        self._patches = [self._wrap(n) for n in ("tensor", "as_tensor", "from_numpy")]
        for p in self._patches:
            p.start()
        return super().__enter__()

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()
        return super().__exit__(*exc)

    def paused(self, fn):
        def run(*args, **kwargs):
            self.__exit__(None, None, None)
            try:
                return fn(*args, **kwargs)
            finally:
                self.__enter__()

        return run


def _guarded(call):
    """``call()`` once to warm up, then once under ``CaptureGuard``; what
    the guard saw in the second call."""
    call()
    with CaptureGuard() as guard:
        call()
    return guard.seen


CONFIGS = [("flagship", {})] + list(checks.VARIANTS)


@pytest.mark.parametrize("variant", [v for _, v in CONFIGS], ids=[n for n, _ in CONFIGS])
def test_captured_paths_read_nothing_on_the_host(variant):
    """The eval forward (``make_eval_forward``), the eval step and a train
    step of the flagship with ``variant``'s fields (float32, B1 V3 64x64):
    after a warm-up call, a second call makes no host-to-tensor
    construction and no host read of a tensor's value. The CPU's Adam
    update is left out: it is not capturable (its step counts live on the
    host), and on the card ``make_optimizer`` takes the capturable Adam,
    which reads nothing there."""
    batch = _batch()
    args = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    cfg = ModelConfig(group_cor=True, group_cor_dim=(8, 8, 4, 4), inverse_depth=True,
                      mono=True, attn_temp=2.0, dtype="float32", **variant)
    model = checks.seeded_model(cfg, 1, "cpu")
    forward = make_eval_forward(model)
    assert _guarded(lambda: forward(*args)) == []
    eval_step = make_eval_step(model, checks.RECIPE_LOSS)
    assert _guarded(lambda: eval_step(batch)) == []

    train_model = checks.small_step_model(3, variant=variant)
    step = make_train_step(train_model, checks.RECIPE_LOSS, make_optimizer(train_model, 1e-4),
                           lambda i: 1e-3)
    step(batch)
    with CaptureGuard() as guard:
        step.optimizer.step = guard.paused(step.optimizer.step)
        step(batch)
    assert guard.seen == []


def test_capture_guard_sees_host_reads_and_constructions():
    """The guard itself: ``.item()``, ``float()`` of a tensor, a boolean
    mask's index, ``torch.tensor`` and ``torch.from_numpy`` are each seen."""
    x = torch.arange(6.0)
    for call in (lambda: x.sum().item(), lambda: float(x.max()), lambda: x[x > 2],
                 lambda: torch.tensor([1.0, 2.0]), lambda: torch.from_numpy(np.ones(2))):
        with CaptureGuard() as guard:
            call()
        assert guard.seen, call


# ------------------------------------------------------------ the cache --

def test_signature_keys_on_structure_shape_dtype_and_values():
    """Equal for the same structure, shapes, dtypes, devices and non-tensor
    values whatever the tensors hold; different for a new shape, dtype,
    nesting, dict key or non-tensor value."""
    t = torch.zeros((2, 3))

    def key(*args, **kwargs):
        return graphs.signature(args, kwargs)[0]

    base = key({"a": t, "b": [t, 1.5]}, scale=2)
    assert key({"a": torch.ones((2, 3)), "b": [t + 1, 1.5]}, scale=2) == base
    for other in (key({"a": torch.zeros((2, 4)), "b": [t, 1.5]}, scale=2),
                  key({"a": t.double(), "b": [t, 1.5]}, scale=2),
                  key({"a": t, "b": (t, 1.5)}, scale=2),
                  key({"a": [t], "b": [t, 1.5]}, scale=2),
                  key({"c": t, "b": [t, 1.5]}, scale=2),
                  key({"a": t, "b": [t, 2.5]}, scale=2),
                  key({"a": t, "b": [t, 1.5]}, scale=3)):
        assert other != base
    assert graphs.signature(({"a": t, "b": [t, 1.5]},))[1] == [t, t]
    with pytest.raises(TypeError):
        graphs.signature(([t], {"unhashable": {1, 2}}))


def test_captured_function_caches_one_graph_per_signature():
    """With a card (stubbed: ``_card``, ``_capture`` and ``_replay``), the
    same signature reuses its entry and a new shape, dtype or nesting
    captures a new one; ``reset`` drops them. Without a card the function
    runs directly and nothing is cached."""
    calls = []
    fn = graphs.capture(lambda tree: calls.append(tree) or "eager", "probe")
    x = torch.zeros((2, 3))
    assert fn({"x": x}) == "eager" and fn.graphs == {} and len(calls) == 1

    captured = []
    with mock.patch.object(graphs.Captured, "_card", lambda self, leaves: torch.device("cuda")), \
            mock.patch.object(graphs.Captured, "_capture",
                              lambda self, key, leaves, dev: captured.append(key) or key), \
            mock.patch.object(graphs.Captured, "_replay",
                              staticmethod(lambda entry, leaves: ("replay", entry))):
        assert fn({"x": x})[0] == "replay"
        fn({"x": torch.ones((2, 3))})
        assert len(captured) == 1 and len(fn.graphs) == 1
        fn({"x": torch.zeros((3, 3))})
        fn({"x": x.double()})
        fn({"x": [x]})
        assert len(captured) == 4 and len(fn.graphs) == 4
        assert fn({"x": x}) == ("replay", captured[0])
    assert len(calls) == 1
    fn.reset()
    assert fn.graphs == {}


def test_eager_block_and_nested_calls_run_directly():
    """``graphs.eager()`` makes a captured function call ``fn`` whatever its
    inputs (``jax.disable_jit``)."""
    fn = graphs.capture(lambda x: x * 2, "double")
    with mock.patch.object(graphs.Captured, "_capture", side_effect=AssertionError), \
            graphs.eager():
        assert fn._card([torch.zeros(1)]) is None
        assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))


# ------------------------------------------------ the learning-rate tensor --

def _float_lr_step(model, optimizer, schedule, batch, i):
    """The train step as it was with a Python-float learning rate."""
    model.train()
    for group in optimizer.param_groups:
        group["lr"] = schedule(i)
    optimizer.zero_grad(set_to_none=True)
    outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    loss, _ = mvs4net_loss(outputs, batch["depth"], batch["mask"], checks.RECIPE_LOSS)
    loss.backward()
    optimizer.step()
    return loss.detach()


def test_tensor_learning_rate_is_bit_equal_to_the_float_one():
    """Three steps of ``TrainStep``, whose learning rate is a float64
    tensor filled from the schedule, against three steps with the rate a
    Python float, from the same weights, across a warm-up schedule: the
    losses, the parameters and Adam's moments equal bit for bit; the
    tensor is every parameter group's ``lr``."""
    batch = _batch()
    schedule = warmup_multistep(1e-3, [2], 0.5, warmup_iters=2)
    a, b = checks.small_step_model(3), checks.small_step_model(3)
    step = make_train_step(a, checks.RECIPE_LOSS, make_optimizer(a, 1e-4), schedule)
    opt_b = make_optimizer(b, 1e-4)
    for i in range(3):
        loss_a = step(batch)["loss"]
        loss_b = _float_lr_step(b, opt_b, schedule, batch, i)
        assert torch.equal(loss_a, loss_b), i
        assert all(g["lr"] is step.lr for g in step.optimizer.param_groups)
        assert step.lr.dtype == torch.float64 and step.lr.item() == schedule(i)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        sa, sb = step.optimizer.state[pa], opt_b.state[pb]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(
            sa["exp_avg_sq"], sb["exp_avg_sq"]), name


# -------------------------------------------------------- the tap tables --

def _resize_axis_per_call(x, axis, n_out):
    """``core/geometry._resize_axis`` as it was: the tap tables built and
    copied per call."""
    n_in = x.shape[axis]
    i0, w0, w1 = geometry.align_corners_taps(n_out, n_in)
    i0 = torch.as_tensor(i0, device=x.device)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w0 = torch.as_tensor(w0, device=x.device).to(x.dtype).view(shape)
    w1 = torch.as_tensor(w1, device=x.device).to(x.dtype).view(shape)
    return x.index_select(axis, i0) * w0 + x.index_select(axis, i1) * w1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_table_cache_hits_and_is_bit_equal(dtype):
    """A second resize at the same sizes takes its tap tables from the
    cache, and every resize (rows and columns, up and down, to and from a
    size of 1) is bit-equal to the tables built per call."""
    gen = torch.Generator().manual_seed(0)
    for (h, w), (ho, wo) in (((8, 12), (16, 24)), ((16, 10), (7, 5)), ((1, 6), (3, 1))):
        x = torch.randn((2, h, w, 3), generator=gen).to(dtype)
        want = _resize_axis_per_call(_resize_axis_per_call(x, 1, ho), 2, wo)
        got = geometry.resize_align_corners(x, (ho, wo))
        assert torch.equal(got, want)
        hits = geometry._device_taps.cache_info().hits
        assert torch.equal(geometry.resize_align_corners(x, (ho, wo)), want)
        assert geometry._device_taps.cache_info().hits == hits + 2


def test_extrinsics_inverse_bottom_row():
    """The rigid inverse's bottom row, made on the device, is [0, 0, 0, 1]
    and the inverse is one."""
    gen = torch.Generator().manual_seed(1)
    q, _ = torch.linalg.qr(torch.randn((5, 3, 3), generator=gen, dtype=torch.float64))
    e = torch.eye(4, dtype=torch.float64).repeat(5, 1, 1)
    e[:, :3, :3] = q
    e[:, :3, 3] = torch.randn((5, 3), generator=gen, dtype=torch.float64)
    inv = geometry.extrinsics_inverse(e)
    assert torch.equal(inv[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0],
                                               dtype=torch.float64).expand(5, 4))
    torch.testing.assert_close(inv @ e, torch.eye(4, dtype=torch.float64).expand(5, 4, 4))


# ----------------------------------------------------- restore and capture --

def test_fit_restores_before_the_first_step(tmp_path):
    """``fit(resume=True)`` restores the checkpoint before the train step's
    first call, the call that captures on the card, so that the graph reads
    the restored optimizer state; training then continues at the saved
    step."""
    ds = SyntheticTrainDataset("synthetic://64x64/2", None, "train", 3)
    model = checks.small_step_model(3)
    seed = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    seed(_batch())
    save_checkpoint(str(tmp_path), 0, seed)
    order = []
    real_restore, real_call = loop.restore_checkpoint, TrainStep.__call__

    def restore(path, state):
        order.append(("restore", state.step, len(state._captured.graphs)))
        return real_restore(path, state)

    def call(self, batch):
        order.append(("step", self.step))
        return real_call(self, batch)

    tcfg = TrainConfig(epochs=2, lr=1e-3, lr_milestones=(10,), summary_freq=1, save_freq=5)
    with mock.patch.object(loop, "restore_checkpoint", restore), \
            mock.patch.object(TrainStep, "__call__", call):
        state = loop.fit(checks.small_step_model(3), DataLoader(ds, 1, num_workers=0), None,
                         tcfg, checks.RECIPE_LOSS, logdir=str(tmp_path), device="cpu",
                         resume=True)
    assert order[0] == ("restore", 0, 0) and order[1] == ("step", 1), order
    assert state.step == 3


def test_restore_drops_captured_graphs(tmp_path):
    """A restore after a step was captured drops its graphs (the
    optimizer's ``load_state_dict`` replaced the state a graph reads): the
    next call captures anew."""
    model = checks.small_step_model(3)
    step = make_train_step(model, checks.RECIPE_LOSS, make_optimizer(model, 1e-4),
                           lambda i: 1e-3)
    path = save_checkpoint(str(tmp_path), 0, step)
    step._captured.graphs["a signature"] = object()
    restore_checkpoint(path, step)
    assert step._captured.graphs == {}
    assert all(isinstance(g["lr"], float) for g in torch.load(path)["optimizer"]["param_groups"])
