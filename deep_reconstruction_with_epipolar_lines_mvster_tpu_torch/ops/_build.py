"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
one ``nvcc`` call builds it in seconds. Libraries go to ``_build/`` inside
the package (ignored by git), named by a digest of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt and
an unchanged one is reused.
Everything is built from the repository's own sources.
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

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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
    compiler log)}`` for the sources it compiled. Raises on any failure."""
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
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


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
