"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] --seconds 3 [--out calib.json]

One process: the cell's set-up once, then for every seed of ``--seeds`` the
seed's inputs, a short window at the cell's own load, and the compared
numbers of the program's outputs; for every seed of ``--control-seeds`` the
same numbers of the control (the path's ``control_outputs``: the reference
in the program's place at the precision below the configuration's); for
every seed of ``--fault-seeds`` those of each fault the path plants in its
outputs (``fault_outputs``), where a number has no control reading. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def make_driver(workload: str, seed: int, seconds: float, device, root: Path = ROOT,
                overrides: "dict | None" = None):
    """The cell's driver, set up once (program loaded, warmed up)."""
    from port_bench.harness import cell, spec

    bench = spec.load_benchmark(root)
    wl = spec.workload(bench, workload)
    config = dict(spec.config(bench, wl["config"], root), **(overrides or {}))
    run = cell.Run(root, wl, config, spec.traffic(wl["traffic"], root), seed, seconds, False,
                   device, time.perf_counter())
    driver = spec.path_driver(run.traffic["path"], root).Driver(run)
    driver.setup()
    return driver


def read_seed(driver, kind: str, seed: int, seconds: float) -> tuple:
    """The seed's inputs, a short window at the cell's load, then the
    compared numbers of the program's outputs (``program``), of the control
    (``control``) or of each fault (``fault``). Returns (readings, steps)."""
    driver.make_inputs(seed)
    k, deadline = 0, time.perf_counter() + seconds
    while k == 0 or time.perf_counter() < deadline:
        driver.step(k)
        k += 1
    driver.pick_judged(seed)
    if kind == "fault":
        return {name: driver.readings(o) for name, o in driver.fault_outputs().items()}, k
    return driver.readings(driver.outputs if kind == "program" else driver.control_outputs()), k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    driver = make_driver(args.workload, (seeds or controls or faults)[0], args.seconds,
                         torch.device("cuda"))
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(),
           "program": {}, "control": {}, "fault": {}}
    for kind, group in (("program", seeds), ("control", controls), ("fault", faults)):
        for seed in group:
            t0 = time.time()
            got, steps = read_seed(driver, kind, seed, args.seconds)
            out[kind][seed] = got
            print(f"{kind} seed {seed} steps {steps} {json.dumps(got)} "
                  f"({time.time() - t0:.1f} s)", flush=True)
    for kind in ("program", "control"):
        if out[kind]:
            keys = next(iter(out[kind].values()))
            agg = {key: [r[key] for r in out[kind].values()] for key in keys}
            out[kind + "_range"] = {key: [min(v), max(v)] for key, v in agg.items()}
            print(kind, "min/max", json.dumps(out[kind + "_range"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
