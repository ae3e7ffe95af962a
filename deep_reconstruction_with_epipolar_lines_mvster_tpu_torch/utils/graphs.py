"""CUDA-graph capture and replay: the port's counterpart of ``jax.jit``.

The JAX package compiles each of its entry points (the eval forward, the
bench's scanned chain, the train and eval steps, fusion's per-view check)
into one program per input signature and replays it. ``capture(fn)`` does
the same on the card: the first call with a new signature records every
launch of ``fn`` into a ``torch.cuda.CUDAGraph``, and every call replays
the graph of its signature.

- **The signature** (``signature``) is the structure of the arguments
  (nested dicts, lists and tuples) with each tensor's shape, dtype and
  device, and the value of every other leaf (Python scalars, configs),
  which must be hashable. JAX's jit retraces on the same key.
- **A new signature, on the card:** static input buffers are allocated
  and filled; one eager call of ``warmup`` (by default ``fn`` itself) on a
  side stream builds what the function creates on first use (the kernel
  libraries of ``ops/_build.py``, cuBLAS and cuDNN handles, the lru caches
  of tap tables, an optimizer's state); then ``fn`` is captured on the
  static inputs into a graph with its own memory pool. The warm-up's
  result is thrown away.
- **Every call** copies its tensors into the static inputs, replays the
  graph and returns the outputs as fresh tensors (clones), so that a later
  call never overwrites an earlier result, as with JAX arrays. Tensors
  that ``fn`` reads without taking them as arguments (a model's
  parameters and buffers, an optimizer's state) are read and written in
  place by the replay, as by the eager call.
- **No fallback.** A capture that fails raises ``CaptureError``, naming
  the function and its input signature; nothing retries eagerly. A
  function that reads a device value on the host (``.item()``, ``float()``,
  a boolean mask's ``nonzero``) or copies host data to the card cannot be
  captured.
- **Inputs from the host** reach the card through pinned memory
  (``to_device``), as the JAX package's ``device_put`` does.
- **The CPU** has no graphs: where no tensor argument is on a CUDA device
  the wrapper calls ``fn`` directly, as the kernel wrappers take their
  plain versions for CPU tensors. So does a call made while another
  captured function warms up or captures (nested jits are inlined), and
  any call inside ``eager()`` (``jax.disable_jit``).

Kernel launch counters (``ops/kernels/*.launches``) count the launches
that the wrappers make: on a new signature the warm-up and the capture
each launch every kernel once; a replay launches the graph and counts
nothing.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_LOCAL = threading.local()


def _direct_depth() -> int:
    return getattr(_LOCAL, "direct", 0)


@contextlib.contextmanager
def eager():
    """Within the block, every captured function runs eagerly (the
    counterpart of ``jax.disable_jit``): the eager readings that a captured
    path is held against, tools that read intermediate values, and the
    calls nested in a warm-up or a capture."""
    _LOCAL.direct = _direct_depth() + 1
    try:
        yield
    finally:
        _LOCAL.direct -= 1


class CaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


def _flatten(tree, leaves: List[torch.Tensor]):
    """The structure of ``tree`` with each tensor's shape, dtype and device
    in place of the tensor, which goes to ``leaves`` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if type(tree) in (list, tuple):     # a NamedTuple is a value
        return (type(tree).__name__, tuple(_flatten(v, leaves) for v in tree))
    return ("value", tree)


def _unflatten(spec, leaves):
    """``tree`` back from ``_flatten``'s structure, its tensors taken from
    the iterator ``leaves``."""
    kind, body = spec[0], spec[1]
    if kind == "tensor":
        return next(leaves)
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in body}
    if kind == "list":
        return [_unflatten(s, leaves) for s in body]
    if kind == "tuple":
        return tuple(_unflatten(s, leaves) for s in body)
    return body


def signature(args: tuple, kwargs: Optional[Dict[str, Any]] = None):
    """``(key, tensors)``: the cache key of a call (its arguments'
    structure, each tensor's shape, dtype and device, every other leaf's
    value) and its tensor arguments in order. Raises ``TypeError`` on a
    non-tensor leaf that cannot be hashed."""
    leaves: List[torch.Tensor] = []
    key = _flatten((tuple(args), tuple(sorted((kwargs or {}).items()))), leaves)
    hash(key)
    return key, leaves


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    out_spec: Tuple
    outputs: List[torch.Tensor]


class Captured:
    """``fn`` captured once per input signature and replayed (module
    docstring). ``fn`` is the eager function; ``graphs`` maps each
    signature captured so far to its graph."""

    def __init__(self, fn: Callable, name: str, warmup: Optional[Callable] = None):
        self.fn = fn
        self.name = name
        self.warmup = warmup or fn
        self.graphs: Dict[Any, _Graph] = {}

    def reset(self) -> None:
        """Drop every graph: the next call of each signature captures anew
        (after state that a graph reads was replaced rather than updated
        in place, such as an optimizer's ``load_state_dict``)."""
        self.graphs.clear()

    def __call__(self, *args, **kwargs):
        key, leaves = signature(args, kwargs)
        device = self._card(leaves)
        if device is None:
            return self.fn(*args, **kwargs)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(key, leaves, device)
        return self._replay(entry, leaves)

    def _card(self, leaves: List[torch.Tensor]) -> Optional[torch.device]:
        """The card that the call's graph runs on, or None where the call
        runs ``fn`` directly (no tensor on a card, inside ``eager()``, or
        inside another function's warm-up or capture)."""
        devices = {t.device for t in leaves}
        if (all(d.type != "cuda" for d in devices) or _direct_depth()
                or torch.cuda.is_current_stream_capturing()):
            return None
        if len(devices) > 1:
            raise CaptureError(f"{self.name}: tensors on {sorted(map(str, devices))}; a graph "
                               "takes its tensors on one card")
        return devices.pop()

    @staticmethod
    def _replay(entry: _Graph, leaves: List[torch.Tensor]):
        for static, t in zip(entry.inputs, leaves):
            static.copy_(t)
        entry.graph.replay()
        return _unflatten(entry.out_spec, (t.clone() for t in entry.outputs))

    def _capture(self, key, leaves: List[torch.Tensor], device: torch.device) -> _Graph:
        """Static inputs, the warm-up on a side stream, then the capture of
        ``fn`` on the static inputs into a graph with its own pool."""
        with torch.inference_mode(False), torch.no_grad():
            inputs = [torch.empty_like(t).copy_(t) for t in leaves]
        args, kwargs = _unflatten(key, iter(inputs))
        kwargs = dict(kwargs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), eager():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.warmup(*args, **kwargs)
            torch.cuda.current_stream().wait_stream(side)
            try:
                with torch.cuda.graph(graph):
                    out = self.fn(*args, **kwargs)
            except Exception as err:
                raise CaptureError(f"{self.name}: capture failed for the input signature "
                                   f"{key}: {err}") from err
        outputs: List[torch.Tensor] = []
        out_spec = _flatten(out, outputs)
        return _Graph(graph, inputs, out_spec, outputs)


def capture(fn: Callable, name: Optional[str] = None,
            warmup: Optional[Callable] = None) -> Captured:
    """``fn`` as a ``Captured``: captured on the card once per input
    signature and replayed (module docstring); ``name`` (by default
    ``fn``'s) names it in errors; ``warmup``, called with the same
    arguments, replaces ``fn``'s own eager warm-up call."""
    return Captured(fn, name or getattr(fn, "__qualname__", repr(fn)), warmup)


def to_device(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a card it goes through
    pinned memory, copied without blocking the host: the pinned buffer
    comes from PyTorch's caching host allocator, which records the copy's
    event and hands the buffer out again only once that copy is done, so
    the host never writes a buffer that a copy still reads."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
