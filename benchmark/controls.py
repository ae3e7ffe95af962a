"""Readings behind the limits of ``correct``: for each seed, the numbers
a run of the program gives (a short window) and those of the control, the
plain reference at the precision below the configuration's (its ``control``
key: ``tf32`` for float32, ``fp8`` for bf16) put in the program's place.

    python3 -m benchmark.controls --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--skip-program] [--skip-control] [--fault <a name of faults.BY_NAME>]

One JSON line a seed on standard output. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from types import SimpleNamespace

import torch

from benchmark import faults, harness


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--skip-program", action="store_true")
    p.add_argument("--skip-control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.BY_NAME),
                   help="run the program with this fault planted (faults.py)")
    a = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[a.workload]
    config = harness.load_json(harness.find("configs", cell["config"]))
    traffic = harness.load_json(harness.find("traffic", cell["traffic"]))
    spec = harness.load_json(harness.find("workloads", a.workload))
    driver = harness.load_module(harness.find("drivers", spec["driver"], ".py"))
    for seed in (int(s) for s in a.seeds.split(",")):
        ctx = SimpleNamespace(name=a.workload, seed=seed, seconds=a.seconds, trace=False,
                              device="cuda", tiny=False, config=config, traffic=traffic,
                              spec=spec, t_start=time.perf_counter())
        line = {"workload": a.workload, "seed": seed, "fault": a.fault}
        if not a.skip_program:
            res = driver.run(ctx, fault=faults.BY_NAME.get(a.fault))
            line["program"] = res["numbers"]
            line["e2e"] = res["e2e"]
            line["check_s"] = res["check_s"]
            del res
            gc.collect()
            torch.cuda.empty_cache()
        if not a.skip_control:
            line["control"] = driver.control(ctx, config["control"])
            line["control_mode"] = config["control"]
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
