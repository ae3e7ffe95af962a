"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference imports nothing of the measured program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = harness.BENCH
SKIP = {"tests", ".cache", "__pycache__"}


def _modules():
    for path in sorted(BENCH.rglob("*.py")):
        if not SKIP & set(path.relative_to(BENCH).parts):
            yield path


def test_no_module_of_the_benchmark_loads_jax():
    """Import every module under ``benchmark/`` (and the program's modules
    the drivers use) in a fresh interpreter, then compare each loaded
    module's top-level name, whole, with JAX's and the JAX package's."""
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(harness.ROOT)!r})",
        "from benchmark import harness",
        "import importlib, pathlib",
        "for p in sys.argv[1:]:",
        "    rel = pathlib.Path(p).relative_to(harness.ROOT).with_suffix('')",
        "    if '.' in rel.name or rel.name == 'run':",
        "        harness.load_module(pathlib.Path(p))",
        "    else:",
        "        importlib.import_module('.'.join(rel.parts).removesuffix('.__init__'))",
        "import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.depthgen",
        "import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.eval.scene_filter",
        "import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.train.step",
        "import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.data.synthetic",
        "print(harness.forbidden_modules())",
    ])
    out = subprocess.run([sys.executable, "-c", code, *map(str, _modules())],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_forbidden_names_are_compared_whole():
    mods = dict.fromkeys(["jaxtyping", "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"])
    saved = {k: sys.modules.get(k) for k in mods}
    try:
        sys.modules.update({k: object() for k in mods})
        assert harness.forbidden_modules() == []
        sys.modules["jax.numpy"] = object()
        assert harness.forbidden_modules() == ["jax.numpy"]
    finally:
        sys.modules.pop("jax.numpy", None)
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "math", "typing", "__future__", "numpy"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in (harness.PROGRAM, *harness.FORBIDDEN), (path, name)
            assert name.startswith(".") or top in allowed, (path, name)
