"""One run of one cell: set-up, the measured window, the traced segments,
the check against the plain reference, and the result line.

A path driver (``port_bench/paths/<path>.py``) defines ``Driver(run)`` with

- ``frames_per_step``: frames one step completes;
- ``setup()``: make the inputs from ``run.seed``, load the program and warm
  up every shape the cell uses (one step of its own shapes);
- ``step(k)``: one closed-loop step (a segment) that returns once its
  output is ready; it may add per-step readings to ``run.spans``;
- ``counts()``: work per step from shapes (FLOPs, bytes) for the readers;
- ``release()``: free what the check does not need (the program's state);
- ``check()``: ``[(name, value, limit)]``, every value a gap that passes
  when it is at most its limit.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from port_bench.harness import spec
from port_bench.harness.trace import profile_steps

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "elvis_tpu")


@dataclass
class Run:
    """What one run knows; the metric readers read it."""

    root: Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace_on: bool
    device: object
    start_time: float
    setup_s: "float | None" = None
    window_s: "float | None" = None
    steps: int = 0
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_s: list = field(default_factory=list)
    spans: dict = field(default_factory=lambda: defaultdict(list))  # name -> [seconds]
    counts: dict = field(default_factory=dict)
    trace: object = None
    memory_peak_bytes: int = 0

    def peaks(self) -> dict:
        with open(Path(self.root) / spec.BENCH_DIR / "counts" / "peaks.json") as f:
            return json.load(f)


def forbidden_loaded() -> list:
    """The JAX-side modules in ``sys.modules``, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def _window(run: Run, driver) -> None:
    import torch

    if run.device.type == "cuda":
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    run.setup_s = t_start - run.start_time
    deadline = t_start + run.seconds
    k = 0
    while True:
        t0 = time.perf_counter()
        if k > 0 and t0 >= deadline:
            break
        run.attempted += 1
        try:
            driver.step(k)
        except Exception:  # a failed segment counts against the attempted ones
            traceback.print_exc(file=sys.stderr)
            run.failed += 1
            if run.failed >= 3:
                raise
        else:
            run.latencies_s.append(time.perf_counter() - t0)
            run.steps += 1
            run.frames += driver.frames_per_step
        k += 1
    run.window_s = time.perf_counter() - t_start


def read_metrics(run: Run, bench: dict, kind: str) -> dict:
    out = {}
    for m in spec.metrics_of(bench, run.cell["name"], kind):
        value = spec.metric_reader(m["name"], run.root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *, root: Path = spec.ROOT,
             device="cuda", start_time: "float | None" = None, overrides: "dict | None" = None,
             driver_hook=None) -> dict:
    """Run ``workload`` once; returns the result line as a dict. ``overrides``
    replace keys of the configuration (a test's small sizes); ``driver_hook``
    gets the driver after set-up (a test breaks the timed path there)."""
    import torch

    root = Path(root)
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    config = dict(spec.config(bench, cell["config"], root), **(overrides or {}))
    traffic = spec.traffic(cell["traffic"], root)
    run = Run(root, cell, config, traffic, int(seed), float(seconds), bool(trace_on),
              torch.device(device), time.time() if start_time is None else start_time)
    # the host clock of the window is perf_counter; set-up is counted from
    # the process's start on the same clock
    run.start_time = time.perf_counter() - (time.time() - run.start_time)
    driver = spec.path_driver(traffic["path"], root).Driver(run)
    driver.setup()
    if driver_hook is not None:
        driver_hook(driver)
    _window(run, driver)
    run.counts = driver.counts()
    if trace_on:
        run.trace = profile_steps(driver.step, int(traffic["trace_steps"]),
                                  driver.frames_per_step)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    metrics = read_metrics(run, bench, "per_layer" if trace_on else "end_to_end")
    driver.release()
    checks = driver.check()
    correct = run.failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {
        "correct": bool(correct),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": _device(run),
    }
    if trace_on:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in checks}
    return result


def _device(run: Run) -> dict:
    import torch

    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": int(run.cell["chips"]), "memory_peak_bytes": run.memory_peak_bytes}


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, and the result as the last line of standard output."""
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
