"""The device trace of a few segments: ``torch.profiler`` over CPU and
CUDA, exported as a Chrome trace under ``TMPDIR``, read back and deleted.

``Trace`` holds what the per-layer readers need: every device operation
(kernels, copies, sets) with its start, duration and the host time of its
launch, the host's ranges on the thread that drove the segments (operators
and the benchmark's own ``record_function`` spans), and the traced window.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"


@dataclass
class DeviceOp:
    name: str
    cat: str
    start_us: float
    dur_us: float
    launch_us: "float | None"  # host time of the launching runtime call


@dataclass
class Trace:
    window_start_us: float
    window_us: float
    ops: list                      # [DeviceOp], sorted by start
    host: list                     # [(start_us, end_us, name)] on the driving thread
    spans: dict = field(default_factory=dict)  # name -> [(start_us, end_us)]
    segments: int = 0
    frames: int = 0

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window."""
        lo, hi = self.window_start_us, self.window_start_us + self.window_us
        merged = []
        for op in self.ops:
            a, b = max(op.start_us, lo), min(op.start_us + op.dur_us, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_percent(self) -> "float | None":
        """Share of the window in which no operation ran on the device, in %."""
        if self.window_us <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def launched_within(self, span: str) -> list:
        """Device operations whose launch lies inside any ``span`` range."""
        return _launched_in(self.ops, self.spans.get(span, []))

    def under_op(self, op_name: str) -> tuple:
        """(operations launched under a host operator named ``op_name``,
        the rest)."""
        inside = _launched_in(self.ops, [(a, b) for a, b, n in self.host if n == op_name])
        ids = {id(op) for op in inside}
        return inside, [op for op in self.ops if id(op) not in ids]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the driving thread was doing, in seconds."""
        by_name = defaultdict(float)
        for op in self.ops:
            by_name[op.name] += op.dur_us / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        lo, hi = self.window_start_us, self.window_start_us + self.window_us
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        host = sorted(self.host, key=lambda r: (r[0], -r[1]))
        gaps = defaultdict(float)
        stack, j = [], 0  # the driving thread's ranges nest: a call stack
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] < host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            gaps[stack[-1][2] if stack else "host idle"] += (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


def _launched_in(ops: list, ranges: list) -> list:
    """The operations of ``ops`` whose launch lies inside one of ``ranges``
    (which may nest or overlap)."""
    merged = []
    for a, b in sorted(ranges):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    out = []
    for op in ops:
        if op.launch_us is None:
            continue
        i = bisect.bisect_right(starts, op.launch_us) - 1
        if i >= 0 and op.launch_us <= merged[i][1]:
            out.append(op)
    return out


def read_chrome_trace(path: str, segments: int, frames: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch = {}
    window = None
    driver_tid = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") == "user_annotation" and ev.get("name") == WINDOW_SPAN:
            window = (float(ev["ts"]), float(ev["dur"]))
            driver_tid = (ev.get("pid"), ev.get("tid"))
        elif ev.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(ev["ts"])
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} range")
    ops, host, spans = [], [], defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            ops.append(DeviceOp(ev.get("name", "?"), cat, float(ev["ts"]), float(ev.get("dur", 0)),
                                launch.get(corr)))
        elif cat in ("cpu_op", "user_annotation") and (ev.get("pid"), ev.get("tid")) == driver_tid:
            s, d = float(ev["ts"]), float(ev.get("dur", 0))
            host.append((s, s + d, ev.get("name", "?")))
            if cat == "user_annotation":
                spans[ev.get("name", "?")].append((s, s + d))
    ops.sort(key=lambda o: o.start_us)
    return Trace(window[0], window[1], ops, host, dict(spans), segments, frames)


def profile_steps(step, count: int, frames_per_step: int):
    """Run ``step(k)`` ``count`` times under the profiler, inside one
    ``bench.window`` range; returns the ``Trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fd, path = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        sync()
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                for k in range(count):
                    step(k)
                sync()
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, count, count * frames_per_step)
    finally:
        os.unlink(path)
