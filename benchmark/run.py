"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything
else is found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (which names the driver), ``drivers/<driver>.py``,
``metrics/<metric>.py``. The driver builds the program from the seed,
warms up the cell's shapes (set-up), measures for ``--seconds``, then
checks what the timed path produced against the plain reference.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the profiled stretch's ``busy_s`` and
``window_s`` and a ``breakdown``. The numbers compared for ``correct`` are
printed last on standard error and under ``checks``, last in the line.

Exits with 2 when the card the cell needs is missing, with 3 when a module
of JAX or of the JAX package is loaded at the end. ``--cpu-tiny`` (the
benchmark's own tests) runs the cell's ``tiny`` sizes on the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program and its libraries at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "benchmark" / ".cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu-tiny", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)

    import torch

    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}; BENCHMARK.json has {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[a.workload]
    if not a.cpu_tiny and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell["chips"]):
        print(f"{a.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = harness.load_json(harness.find("configs", cell["config"]))
    traffic = harness.load_json(harness.find("traffic", cell["traffic"]))
    if a.cpu_tiny:
        traffic = {**traffic, **traffic.get("tiny", {})}
    spec = harness.load_json(harness.find("workloads", a.workload))
    driver = harness.load_module(harness.find("drivers", spec["driver"], ".py"))
    ctx = SimpleNamespace(name=a.workload, seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
                          device="cpu" if a.cpu_tiny else "cuda", tiny=a.cpu_tiny,
                          config=config, traffic=traffic, spec=spec, t_start=T_START)
    res = driver.run(ctx)

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    reported = {n for n, m in e2e.items() if n in res["e2e"]
                and ("workloads" not in m or a.workload in m["workloads"])}
    metrics = {}
    if not a.trace:
        for n in sorted(reported):
            metrics[n] = {"value": res["e2e"][n], "unit": e2e[n]["unit"]}
    else:
        for m in bench["per_layer"]:
            # listed for this cell, or, without a list, in every cell reporting what it moves
            if a.workload not in m.get("workloads", [a.workload] if m["moves"] in reported else []):
                continue
            reader = harness.load_module(harness.find("metrics", m["name"], ".py"))
            value = reader.read(res)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(res["device"])
    trace = res.get("trace") or {}
    if a.trace and trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]

    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    if a.trace:
        # the traced run's own end-to-end readings, against an untraced run's: the tracing's cost
        print("traced run: " + " ".join(f"{k}={v!r}" for k, v in sorted(res["e2e"].items())),
              file=sys.stderr)
    checks = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in res["checks"]}
    line = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device}
    if a.trace and trace:
        line["breakdown"] = harness.breakdown(trace)
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
