#!/usr/bin/env python3
"""Time K6's float32 route in forced launch shapes against each other, on
one card.

    python -m deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools.k6_f32_variants \
        [--parent DIR]

Builds ``csrc/band_conv.cu`` into libraries of its own (under ``_build/``),
one a variant, each ``nvcc`` started together:

- ``cur``: the source as it stands (the launch shapes ``f32_plan`` chooses);
- ``a``: CTAs of 8 warps (4 at Co over 32: 1 warp a group), 2 rows a thread:
  tiles of 32 / COG rows, the redesign's first tiles;
- ``b``: CTAs of 4 warps (8 at Co over 32), 2 rows a thread, whatever the
  work items;
- ``c``: as ``b``, 1 row a thread (tiles of half the rows);
- ``cpasync``: ``cur`` without the 3-D TMA map, so that Ci <= 3 takes the
  4-byte cp.async copy;
- ``parent``, with ``--parent``: ``csrc/band_conv.cu`` of another checkout
  (same C interface), built against that checkout's headers.

The variants differ from ``cur`` in ``f32_plan`` and the instances it
dispatches to, or the copy mode it picks; a source whose text no longer
matches fails here. Then at every 3x3 layer of ``chip_smoke.py``'s
``_band_conv_layers`` in float32, at B4 and at one pipeline view (B1),
each variant is held against ``band_conv_ref`` (max |diff| over the
tolerance, ``err``) and timed on the device: 20 launches captured in one
CUDA graph, the median of 5 replays, the variants in order and then
reversed. Prints the card's name and power limit, one JSON line a layer and
a table of the two orders' mean, in us. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops.kernels import band_conv as k6

RULE = """    p.rq = std::max(1, 4 / p.cog);
    p.rt = 2;
    if (f32_items(N, H, W, Co, p.cog, p.rq, p.rt) < 2LL * sms) p.rt = 1;
"""
TMA3 = ": aligned && Ci <= 3 && W * Ci % 4 == 0 ? F32_TMA3"
DISPATCH = "    switch (p.cog) {\n        case 1: return launch_f32_rt<1, 4>("
ARGS = "x, w, scale, bias, out, N, H, W, Ci, Co, p, s"
# (COG, RQ, RT) instances the forced plans take
INSTANCES = [(1, 8, 2), (1, 4, 2), (1, 4, 1), (2, 4, 2), (2, 2, 2), (2, 2, 1), (4, 2, 2),
             (4, 1, 2), (4, 1, 1), (8, 1, 2), (8, 1, 1)]
FORCED = {
    "a": "    p.rq = 8 / p.cog;\n    p.rt = 2;\n",
    "b": "    p.rq = std::max(1, 4 / p.cog);\n    p.rt = 2;\n",
    "c": "    p.rq = std::max(1, 4 / p.cog);\n    p.rt = 1;\n",
}


def _chip_smoke():
    """``chip_smoke.py`` of the checkout this package lies in, as a module."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variant_sources(src: str) -> dict:
    """``{name: source}`` of the variants made from ``src`` (module
    docstring)."""
    for anchor in (RULE, TMA3, DISPATCH):
        if anchor not in src:
            raise ValueError(f"band_conv.cu no longer holds {anchor!r}")
    i = src.index(DISPATCH)
    j = src.index("    }\n}\n", i) + len("    }\n}\n")
    cases = "".join(f"        case {c * 100 + q * 10 + t}: return launch_f32<{c}, {q}, {t}>({ARGS});\n"
                    for c, q, t in INSTANCES)
    generic = (src[:i] + "    switch (p.cog * 100 + p.rq * 10 + p.rt) {\n" + cases
               + "        default: return (int)cudaErrorInvalidValue;\n    }\n}\n" + src[j:])
    out = {"cur": src}
    out.update({name: generic.replace(RULE, rule) for name, rule in FORCED.items()})
    out["cpasync"] = src.replace(TMA3, ": false ? F32_TMA3")
    return out


def build(variants: dict, parent: str | None) -> dict:
    """Compile each variant (and the parent's source) into
    ``_build/k6_variants/<name>.so``; ``{name: launch function}``."""
    out_dir = _build.BUILD_DIR / "k6_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    sources = {name: (text, _build.CSRC_DIR) for name, text in variants.items()}
    if parent:
        csrc = Path(parent).resolve() / _build.PKG_DIR.name / "csrc"
        sources["parent"] = ((csrc / "band_conv.cu").read_text(), csrc)
    for name, (text, include) in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
               str(out_dir / f"{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    fns = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).band_conv_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose csrc/band_conv.cu is timed beside")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_f32_variants: CUDA is not available", file=sys.stderr)
        return 1
    smoke = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    fns = build(variant_sources((_build.CSRC_DIR / "band_conv.cu").read_text()), a.parent)
    names = list(fns)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
    table = []
    for batch in (smoke.B, 1):
        for layer, n, h, w, ci, co, _ in smoke._band_conv_layers(batch):
            x, wt, sc, bs = smoke._band_conv_args(dev, gen, n, h, w, ci, co, torch.float32)[0]
            want = k6.band_conv_ref(x, wt, sc, bs)
            tol = k6.TOLERANCE[torch.float32] * smoke._scale(want)
            row = {"batch": batch, "layer": layer, "shape": [n, h, w, ci, co],
                   "plan": k6.plan(n, h, w, ci, co, torch.float32), "err": {}, "us": {}}
            runs = {}
            for name in names:
                out = torch.empty_like(want)

                def run(fn=fns[name], out=out, name=name):
                    status = fn(x.data_ptr(), wt.data_ptr(), sc.data_ptr(), bs.data_ptr(),
                                out.data_ptr(), n, h, w, ci, co, 0, 0, 0,
                                torch.cuda.current_stream().cuda_stream)
                    _build.check(status, f"band_conv variant {name}")

                run()
                torch.cuda.synchronize()
                row["err"][name] = smoke._max_err(out, want) / tol
                if row["err"][name] > 1.0:
                    raise AssertionError(f"{name} at {layer} B{batch}: {row['err'][name]} of tol")
                runs[name] = run
            for order in (names, names[::-1]):
                for name in order:
                    row["us"].setdefault(name, []).append(
                        smoke._time_graph_ms(runs[name], 20, 5) * 1e3)
            print(json.dumps(row), flush=True)
            table.append(row)
    print("us per layer, mean of the two orders:")
    print(f"{'':30}" + "".join(f"{name:>9}" for name in names))
    for row in table:
        print(f"B{row['batch']} {row['layer']:<27}"
              + "".join(f"{sum(row['us'][nm]) / 2:9.1f}" for nm in names))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
