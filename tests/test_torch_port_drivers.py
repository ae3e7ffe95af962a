"""The port's drivers (``graft_entry.py``, ``bench.py``,
``scripts/bench_scaling.py``, ``tools/roofline.py``,
``tools/trace_table.py``, ``tools/train_demo.py``) on the CPU, against the
JAX repo's ``__graft_entry__.py``, ``_roofline.py`` and the JAX package.

The multi-process drivers (the dry run over two gloo ranks, the scaling
harness at one and two ranks) and the demo run as their command lines do,
started together by a module fixture so that they run while the in-process
tests do; each test reads its own process's output.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from deep_reconstruction_with_epipolar_lines_mvster_tpu.models import MVS4Net as JaxMVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch import bench, graft_entry
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.config import ModelConfig
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.models import MVS4Net
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.tools import roofline, trace_table
from deep_reconstruction_with_epipolar_lines_mvster_tpu_torch.utils.jax_params import (
    jax_variables_to_state_dict,
)
from test_torch_port_model import _jax_inputs, _variables

REPO = Path(__file__).resolve().parents[1]
PKG = "deep_reconstruction_with_epipolar_lines_mvster_tpu_torch"
DRIVER_TIMEOUT_S = 600

# each started driver: (module, arguments)
DRIVERS = {
    "dryrun": ("graft_entry", ["2", "--device", "cpu"]),
    "scaling": ("scripts.bench_scaling", ["64", "64", "2", "1", "--device", "cpu",
                                          "--world", "2"]),
    "demo": ("tools.train_demo", ["--steps", "2", "--device", "cpu"]),
}


@pytest.fixture(scope="module")
def started():
    """Every driver of ``DRIVERS`` started at once (two torch threads
    each); ``output(name)`` waits for one and returns its standard output."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    procs = {name: subprocess.Popen([sys.executable, "-m", f"{PKG}.{module}", *args],
                                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (module, args) in DRIVERS.items()}

    def output(name):
        out, err = procs[name].communicate(timeout=DRIVER_TIMEOUT_S)
        assert procs[name].returncode == 0, (name, err[-3000:])
        return out.strip().splitlines()

    try:
        yield output
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads here, as the started processes use: under several
    test workers, more wait at OpenMP barriers for descheduled threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_dtu_model_config_is_the_jax_flagship():
    """Every field of JAX ``_dtu_model().cfg`` that the port's
    ``ModelConfig`` has is equal in ``dtu_model_config()``."""
    jcfg = dataclasses.asdict(ge._dtu_model().cfg)
    mine = dataclasses.asdict(graft_entry.dtu_model_config())
    shared = [k for k in mine if k in jcfg]
    assert len(shared) == len(mine)
    assert {k: mine[k] for k in shared} == {k: jcfg[k] for k in shared}


def test_example_batch_is_the_jax_batch():
    """``example_batch(B=2, V=2, H=64, W=64)`` equals JAX ``_example_batch``
    of the same arguments bit for bit, in every tensor the port keeps."""
    got = graft_entry.example_batch(B=2, V=2, H=64, W=64, device="cpu")
    want = ge._example_batch(B=2, V=2, H=64, W=64)
    for key in ("imgs", "depth_values"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("proj_matrices", "depth", "mask"):
        assert got[key].keys() == want[key].keys()
        for stage in want[key]:
            np.testing.assert_array_equal(got[key][stage].numpy(),
                                          np.asarray(want[key][stage]), err_msg=(key, stage))


def test_entry_fn_is_the_model_forward():
    """``entry(device="cpu")``: ``fn`` on its example arguments (B1 V4
    256x320 bf16) gives the stage-4 depth and confidence of
    ``MVS4Net.forward`` of the same seeded model, bit for bit."""
    fn, args = graft_entry.entry(device="cpu")
    assert args[0].shape == (1, 4, 256, 320, 3)
    depth, conf = fn(*args)
    with torch.inference_mode():
        out = graft_entry.dtu_model("cpu")(*args)["stage4"]
    torch.testing.assert_close(depth, out["depth"], rtol=0, atol=0)
    torch.testing.assert_close(conf, out["photometric_confidence"], rtol=0, atol=0,
                               equal_nan=True)


def test_entry_fn_matches_jax_flagship_float32():
    """``eval_fn`` of the flagship config in float32 at B1 V2 64x64 against
    JAX ``_dtu_model()``'s config (``warp_impl="gather"``, fused top-down
    and packed convs off: execution choices, not the function) with the
    same seeded weights, carried by ``utils/jax_params.py``; the tolerance
    of ``test_torch_port_model.py``: depth equal (rtol 1e-5) at >= 99% of
    pixels, confidence within atol 1e-4 where |Σ_D score| > 0.1."""
    scene = ge._example_batch(B=1, V=2, H=64, W=64)
    scene = jax.tree_util.tree_map(np.asarray, scene)
    jcfg = dataclasses.replace(ge._dtu_model().cfg, dtype="float32", remat=False,
                               warp_impl="gather", fused_topdown=False, pack_conv=False)
    jnet = JaxMVS4Net(jcfg)
    vs = _variables(jnet, scene)
    jout = jnet.apply(vs, *_jax_inputs(scene), train=False)["stage4"]
    port = MVS4Net(graft_entry.dtu_model_config("float32"), device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(vs))
    sums = []
    hook = port.reg[3].register_forward_hook(
        lambda m, i, o: sums.append(o.float().reshape(-1, 4, *o.shape[1:]).sum(1).numpy()))
    t = graft_entry.example_batch(B=1, V=2, H=64, W=64, device="cpu")
    depth, conf = graft_entry.eval_fn(port)(t["imgs"], t["proj_matrices"], t["depth_values"])
    hook.remove()
    same = np.isclose(depth.numpy(), np.asarray(jout["depth"]), rtol=1e-5, atol=0)
    assert same.mean() >= 0.99, same.mean()
    well = np.abs(sums[0]) > 0.1
    assert well.mean() > 0.9, well.mean()
    np.testing.assert_allclose(conf.numpy()[well],
                               np.asarray(jout["photometric_confidence"])[well], atol=1e-4)


def test_bench_runs_tiny_on_cpu_and_refuses_without_a_card(capsys):
    """``bench.main`` at B1 V2 64x64, CHAIN = ROUNDS = GROUPS = 1 on the
    CPU prints one last line with the JAX bench's keys and ``device``;
    without ``--device cpu`` (no card here) it raises."""
    line = bench.main(["--device", "cpu", "--B", "1", "--V", "2", "--H", "64", "--W", "64",
                       "--chain", "1", "--rounds", "1", "--groups", "1"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "spread_maps_per_s",
                         "groups_maps_per_s", "device"}
    assert line["metric"] == "depth_maps_per_s_512x640_v4" and line["value"] > 0
    assert line["vs_baseline"] == 1.0 and line["device"] == "cpu"
    assert len(line["groups_maps_per_s"]) == 1 and line["spread_maps_per_s"] == 0.0
    detail = json.loads(printed[-2])["bench"]
    assert detail["ms_per_forward"] > 0 and detail["h100_bound_ms"] > 0
    assert detail["mfu"] is None and detail["bound_share"] is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--B", "1", "--V", "2", "--H", "64", "--W", "64"])


def test_scaling_harness_on_two_gloo_ranks(started):
    """``scripts/bench_scaling.py`` at 64x64 V2, one sample a rank, up to
    two gloo ranks: a set-up line and a row for 1 and for 2 ranks."""
    lines = [json.loads(x) for x in started("scaling")]
    setups = [x["setup"] for x in lines if "setup" in x]
    rows = [x for x in lines if "setup" not in x]
    assert [r["devices"] for r in rows] == [1, 2] == [s["devices"] for s in setups]
    assert [r["global_batch"] for r in rows] == [1, 2]
    assert rows[0]["scaling_efficiency"] == 1.0
    for r, s in zip(rows, setups):
        assert set(r) == {"devices", "global_batch", "step_s", "samples_per_s",
                          "scaling_efficiency"}
        assert r["step_s"] > 0 and math.isclose(r["samples_per_s"],
                                                r["global_batch"] / r["step_s"])
        assert {"process_group_s", "model_build_s", "first_step_s",
                "second_step_s"} <= set(s)


def test_dryrun_multichip_on_two_gloo_ranks(started):
    """``graft_entry 2 --device cpu`` (``dryrun_multichip(2, "cpu")``) prints
    JAX's ok line with a finite loss for each of the four parts."""
    last = started("dryrun")[-1]
    assert last.startswith("dryrun_multichip(2) ok: "), last
    parts = dict(x[len("loss["):].split("]=") for x in last.split(": ", 1)[1].split())
    assert list(parts) == ["gspmd", "shard_map", "space_eval_rows",
                           "space_eval_flagship_kernels"]
    assert all(math.isfinite(float(v)) for v in parts.values()), parts


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    """Without a card the dry run raises unless asked for the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)


def test_train_demo_two_steps(started):
    """``tools/train_demo.py --steps 2 --device cpu`` prints the loss, the
    depth error and the 8 mm share of steps 0 and 1, all finite, and the
    total seconds."""
    lines = started("demo")
    steps = [x for x in lines if x.startswith("step ")]
    assert [x.split(":")[0] for x in steps] == ["step 0", "step 1"]
    for x in steps:
        values = dict(v.split("=") for v in x.split(": ")[1].split())
        assert list(values) == ["loss", "abs_err", "thres8mm"]
        assert all(math.isfinite(float(v.rstrip("%"))) for v in values.values())
    assert lines[-1].startswith("total ")


def test_roofline_conv_flops_are_the_forward_s():
    """The roofline's convolution FLOPs equal ``FlopCounterMode``'s count of
    the port's CPU float32 forward at B1 V2 64x64 (convolutions and
    matmuls) within 1%."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = graft_entry.dtu_model_config("float32")
    model = MVS4Net(cfg, device="cpu")
    b = graft_entry.example_batch(B=1, V=2, H=64, W=64, device="cpu")
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(b["imgs"], b["proj_matrices"], b["depth_values"])
    counted = counter.get_total_flops()
    ops = {str(k).split(".")[1] for k in counter.get_flop_counts()["Global"]}
    assert ops <= {"convolution", "bmm", "mm", "addmm"}, ops
    roof = roofline.roofline(cfg, 1, 2, 64, 64)
    assert abs(roof["conv_flops"] / counted - 1) < 0.01, (roof["conv_flops"], counted)
    assert roof["bound_ms"] == sum(p["bound_ms"] for p in roof["pieces"]) > 0


def test_roofline_stage_table_is_the_jax_scripts():
    """The stage table derived from the flagship config at 512x640 equals
    ``_roofline.py``'s hard-coded ``STAGES``; other variants are refused."""
    tree = ast.parse((REPO / "_roofline.py").read_text())
    stages = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "STAGES")
    assert roofline.stage_table(graft_entry.dtu_model_config(), 512, 640) == \
        [tuple(s) for s in stages]
    with pytest.raises(ValueError, match="roofline covers"):
        roofline.pieces(ModelConfig(group_cor=True, reg_mode="reg3d"), 1, 2, 64, 64)


def test_trace_table_sums_a_hand_made_trace(tmp_path, capsys):
    """``tools/trace_table.py`` on a Chrome trace of two iterations: device
    events by category (a port kernel, cuDNN, a GEMM, a copy, an
    elementwise kernel, an unknown one), host events left out."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "warp_cor_kernel<8>", "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "band_conv_kernel_mma", "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16", "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm_tn", "dur": 200.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel",
         "dur": 60.0},
        {"ph": "X", "cat": "kernel", "name": "mystery", "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "warp_cor_kernel<8>"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace_table.table(str(path), iters=2, top=3)
    assert out["by_category"] == pytest.approx({
        "K1": 0.15, "K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.05,
        "conv_library": 0.25, "gemm": 0.1, "copies": 0.02, "elementwise": 0.03, "other": 0.01})
    assert math.isclose(out["device_ms"], 0.61)
    assert [t["kernel"] for t in out["top"]] == [
        "sm90_xmma_fprop_implicit_gemm_bf16", "warp_cor_kernel<8>", "sm90_gemm_tn"]
    assert "device total 0.610 ms/iter" in capsys.readouterr().out


def test_new_modules_are_in_the_import_scans():
    """The JAX-free scans of tests/test_torch_port_ops.py (AST, and a fresh
    interpreter importing every module, which walks packages only) cover
    the six drivers."""
    import pkgutil

    import deep_reconstruction_with_epipolar_lines_mvster_tpu_torch as port
    from test_torch_port_ops import PORT, REPO as OPS_REPO, _port_sources

    drivers = {"graft_entry.py", "bench.py", "scripts/bench_scaling.py", "tools/roofline.py",
               "tools/trace_table.py", "tools/train_demo.py"}
    names = {str(f.relative_to(OPS_REPO / PORT)) for f in _port_sources()
             if f.name != "chip_smoke.py"}
    assert drivers <= names
    walked = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
    assert {f"{PKG}.{d[:-3].replace('/', '.')}" for d in drivers} <= walked
