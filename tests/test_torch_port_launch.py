"""The one launch protocol of the port's kernels (``ops/_build.py``), on the
CPU: a ``Kernel`` looks its C entry up and types it once, passes the
device's current stream last, raises on a CUDA error naming the kernel and
counts each launch in ``<name>.launches``; ``launch_counts`` reads that
counter for every kernel of ``KERNELS``; every wrapper launches through
it. The C entries are stubbed by Python callables, as no card is here.
"""

from __future__ import annotations

import ctypes
import importlib
import types

import pytest
import torch

from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.ops import _build

STREAM = 0x5EED


class _Fn:
    """A stand-in for a ctypes function: records its calls, returns ``status``."""

    def __init__(self, status: int = 0):
        self.status, self.calls = status, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.status


@pytest.fixture
def stub(monkeypatch):
    """``_build.load`` handing out one library of ``_Fn`` entries (counting
    its loads), and a current stream of ``STREAM`` on any device."""
    libs, loads = {}, []

    def load(name):
        loads.append(name)
        return libs.setdefault(name, types.SimpleNamespace(
            entry_launch=_Fn(), entry_plan=_Fn(), failing_launch=_Fn(700)))

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=STREAM))
    return libs, loads


def _since(before):
    now = _build.launch_counts()
    return {name: now[name] - before[name] for name in now}


def test_launch_counts_names_every_kernel():
    counts = _build.launch_counts()
    assert tuple(counts) == _build.KERNELS
    assert all(isinstance(n, int) and n >= 0 for n in counts.values())


def test_a_launch_passes_the_stream_and_counts_once(stub):
    libs, loads = stub
    kernel = _build.Kernel("topdown", "entry_launch", [ctypes.c_void_p, ctypes.c_int])
    x = torch.zeros(4)
    before = _build.launch_counts()
    kernel.launch("cuda:0", x, 7)
    kernel.launch("cuda:0", None, 8)
    fn = libs["topdown"].entry_launch
    assert fn.calls == [(x.data_ptr(), 7, STREAM), (None, 8, STREAM)]
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert loads == ["topdown"]                     # looked up and typed once
    assert _since(before) == {name: 2 * (name == "topdown") for name in _build.KERNELS}


def test_a_failed_launch_raises_naming_the_kernel_and_counts_nothing(stub):
    kernel = _build.Kernel("norm_act", "failing_launch", [ctypes.c_int])
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match=r"norm_act \(failing_launch\): CUDA error 700"):
        kernel.launch("cuda:0", 1)
    assert _since(before) == dict.fromkeys(_build.KERNELS, 0)


def test_a_plan_entry_returns_its_status_and_counts_nothing(stub):
    libs, _ = stub
    plan = _build.Entry("warp_cor", "entry_plan", [ctypes.c_int])
    before = _build.launch_counts()
    assert plan.status(3) == 0
    plan.run(4)
    libs["warp_cor"].entry_plan.status = 2
    assert plan.status(5) == 2
    with pytest.raises(RuntimeError, match=r"warp_cor \(entry_plan\): CUDA error 2"):
        plan.run(6)
    assert libs["warp_cor"].entry_plan.calls == [(3,), (4,), (5,), (6,)]
    assert _since(before) == dict.fromkeys(_build.KERNELS, 0)


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_wrapper_launches_through_the_seam(name):
    """Each kernel's wrapper declares its launch entry as a ``Kernel`` of its
    own name, and keeps no launch plumbing or counter of its own."""
    mod = importlib.import_module(f"{_build.__package__}.kernels.{name}")
    assert isinstance(mod._LAUNCH, _build.Kernel) and mod._LAUNCH.name == name
    assert mod._LAUNCH.argtypes[-1] is ctypes.c_void_p            # the stream
    assert not hasattr(mod, "launches") and not hasattr(mod, "_lib")
