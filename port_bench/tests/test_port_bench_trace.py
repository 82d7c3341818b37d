"""The trace reader on a small Chrome trace made by hand: the window, busy
and idle time, operations under a host operator or inside a span, and the
breakdown."""

import json

from port_bench.harness import trace


def _trace(tmp_path):
    tid = {"pid": 1, "tid": 7}
    ev = [
        dict(ph="X", cat="user_annotation", name="bench.window", ts=0, dur=100, **tid),
        dict(ph="X", cat="user_annotation", name="bench.encode", ts=10, dur=40, **tid),
        dict(ph="X", cat="cpu_op", name="aten::convolution", ts=12, dur=5, **tid),
        dict(ph="X", cat="cpu_op", name="aten::add", ts=30, dur=2, **tid),
        dict(ph="X", cat="cpu_op", name="range_coder", ts=60, dur=30, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=13, dur=1,
             args={"correlation": 1}, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=31, dur=1,
             args={"correlation": 2}, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=55, dur=1,
             args={"correlation": 3}, **tid),
        dict(ph="X", cat="kernel", name="conv_kernel", ts=14, dur=10, args={"correlation": 1},
             pid=0, tid=1),
        dict(ph="X", cat="kernel", name="add_kernel", ts=20, dur=20, args={"correlation": 2},
             pid=0, tid=1),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=56, dur=4,
             args={"correlation": 3}, pid=0, tid=1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(str(path), segments=2, frames=16)


def test_busy_idle_and_window(tmp_path):
    t = _trace(tmp_path)
    assert t.window_us == 100 and t.segments == 2 and t.frames == 16
    assert t.busy_intervals() == [[14, 40], [56, 60]]
    assert abs(t.busy_s() - 30e-6) < 1e-12


def test_under_op_and_span(tmp_path):
    t = _trace(tmp_path)
    inside, rest = t.under_op("aten::convolution")
    assert [o.name for o in inside] == ["conv_kernel"]
    assert sorted(o.name for o in rest) == ["Memcpy DtoH", "add_kernel"]
    assert sorted(o.name for o in t.launched_within("bench.encode")) == ["add_kernel",
                                                                        "conv_kernel"]


def test_breakdown(tmp_path):
    b = _trace(tmp_path).breakdown()
    assert b["device_ops"][0] == ["add_kernel", 20e-6]
    gaps = dict(b["idle_gaps"])
    # 0-14 and 40-56 inside bench.encode / the window, 60-100 under range_coder's middle
    assert abs(sum(gaps.values()) - 70e-6) < 1e-12
    assert "range_coder" in gaps and "bench.encode" in gaps


def test_idle_percent(tmp_path):
    assert abs(_trace(tmp_path).idle_percent() - 70.0) < 1e-9


def test_decode_ms_reads_the_window_alone():
    """The client's traced segments, which the profiler slows, stay out of
    ``decode_ms.client``: it reads the decodes of the window's steps only."""
    import torch

    from port_bench.calibrate import make_driver
    from port_bench.harness import spec
    from port_bench.tests.conftest import SMALL

    driver = make_driver("student_1080p_client", 2**31 + 211, 1.0, torch.device("cpu"),
                         overrides=SMALL)
    run = driver.run
    for k in range(3):  # the window
        driver.step(k)
    run.steps, run.frames = 3, 3 * driver.frames_per_step
    driver.counts()
    driver.step(3)      # a traced segment after the window
    window = list(run.spans["decode_s"])
    assert len(window) == 3 and len(driver.decode_s) == 4
    want = 1e3 * sum(window) / run.frames
    assert spec.metric_reader("decode_ms.client").read(run) == want
