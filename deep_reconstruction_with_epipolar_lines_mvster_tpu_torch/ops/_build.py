"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
one ``nvcc`` call builds it in seconds. Libraries go to ``_build/`` inside
the package (ignored by git), named by a digest of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt and
an unchanged one is reused.
Everything is built from the repository's own sources.

A wrapper under ``ops/kernels/`` declares its C entries once (``Kernel``,
``Entry``); ``Kernel.launch`` launches and counts ``<name>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..utils import trace

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the port's kernels, one ``csrc/<name>.cu`` each: K1 warp + group
# correlation, K2 top-down level, K3 warp backward, K4 warp forward, K5
# attention accumulation, K6 conv + folded BatchNorm + ReLU; norm_act the
# eval BatchNorm + ReLU after a library convolution; deform_conv a DCN head's
# taps and their contraction; bn_train the train-mode BatchNorm + ReLU and
# its backward; convnext_block a patchify ConvNeXt block
KERNELS = ("warp_cor", "topdown", "warp_bwd", "warp_fwd", "attn_fuse", "band_conv", "norm_act",
           "deform_conv", "bn_train", "convnext_block")

# every kernel's but deform_conv's and convnext_block's (bf16)
DTYPES = (torch.float32, torch.bfloat16)

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a digest of the source,
    the shared headers and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together. Returns ``{name: (seconds,
    compiler log)}`` for the sources it compiled, counted in
    ``kernels.built`` (``utils/trace``). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, lib, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        done[name] = (time.perf_counter() - t0, log)
    trace.count("kernels.built", len(done))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed; its
    first load (the build, if any, and the ``dlopen``) is a ``kernels.load``
    span (``utils/trace``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with trace.span("kernels.load"):
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


class Entry:
    """C function ``symbol`` of ``csrc/<name>.cu`` (a ``*_plan``) taking ``argtypes``,
    returning a status (0 or a CUDA error); loaded and typed at the first call."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name, self.symbol, self.argtypes, self._fn = name, symbol, argtypes, None

    def status(self, *args) -> int:
        """Call the entry; its status, for the caller to read."""
        if self._fn is None:
            fn = getattr(load(self.name), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        return self._fn(*args)

    def run(self, *args) -> None:
        """Call the entry; raise on a CUDA error."""
        status = self.status(*args)
        if status != 0:
            raise RuntimeError(f"{self.name} ({self.symbol}): CUDA error {status}")


class Kernel(Entry):
    """A kernel's launch entry: ``argtypes``, then the stream."""

    def __init__(self, name: str, symbol: str, argtypes):
        super().__init__(name, symbol, [*argtypes, ctypes.c_void_p])

    def launch(self, device, *args) -> None:
        """Launch on ``device``'s current stream (the last argument), tensors
        as their pointers; raise on a CUDA error; count ``<name>.launches``."""
        self.run(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 torch.cuda.current_stream(device).cuda_stream)
        trace.count(f"{self.name}.launches")


def launch_counts() -> dict:
    """``{name: launches so far}`` for every kernel of ``KERNELS``, from
    ``utils/trace``; a reader counts a stretch by the difference."""
    counters = trace.snapshot()["counters"]
    return {name: counters.get(f"{name}.launches", 0) for name in KERNELS}


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if autograd would record a kernel launch. A kernel launched on
    raw pointers gives outputs with no ``grad_fn``, so gradients would stop
    there without an error; a kernel is reached under autograd only through
    its ``torch.autograd.Function`` (``ops/warp.py``,
    ``ops/topdown_chain.py``), whose forward and backward run with grad
    mode off."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{what}: a CUDA kernel cannot be recorded by autograd; call it "
            "through its autograd.Function or under torch.no_grad()"
        )
