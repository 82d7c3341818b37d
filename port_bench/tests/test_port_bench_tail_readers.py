"""The readers of the SR nets' tail: ``tail_ms.restore`` on small Chrome
traces made by hand (the device time launched inside ``srnet.tail``, per
segment, nothing where the span is missing) and
``tail_fused_share.restore`` on the program's ``nets`` counters (nothing
where the counters or their registry are missing)."""

import json
import sys
from types import SimpleNamespace

from port_bench.harness import spec, trace

TID = {"pid": 1, "tid": 7}
DEV = {"pid": 0, "tid": 1}


def _span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, **TID)


def _launch(corr, ts, name, dur):
    """A runtime call at ``ts`` and the kernel it launched."""
    return [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=1,
                 args={"correlation": corr}, **TID),
            dict(ph="X", cat="kernel", name=name, ts=ts + 2, dur=dur,
                 args={"correlation": corr}, **DEV)]


def _metric(name, t):
    return spec.metric_reader(name).read(SimpleNamespace(trace=t))


def _tail_trace(tmp_path, with_spans):
    """Two segments, each a net call with its tail span around a cast and
    the conv, a trunk kernel before it and a clamp after it."""
    ev = [_span("bench.window", 0, 2000)]
    for s, base in enumerate((0, 1000)):
        if with_spans:
            ev.append(_span("srnet.tail", base + 500, 200))
        c = 10 * s
        ev += _launch(c + 1, base + 100, "trunk", 300)
        ev += _launch(c + 2, base + 510, "cast", 20)
        ev += _launch(c + 3, base + 550, "tail_conv_kernel", 40)
        ev += _launch(c + 4, base + 800, "clamp", 5)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(str(path), segments=2, frames=16)


def test_tail_ms_reads_the_tail_spans(tmp_path):
    """``tail_ms.restore`` sums what launched inside the tail spans, per
    segment; without the spans, or without a trace, it reads None."""
    assert _metric("tail_ms.restore", _tail_trace(tmp_path, True)) == (20 + 40) / 1e3
    assert _metric("tail_ms.restore", _tail_trace(tmp_path, False)) is None
    assert _metric("tail_ms.restore", None) is None


def test_tail_fused_share_reads_the_counters(monkeypatch):
    import elvis_tpu_torch.utils.trace as program

    monkeypatch.setattr(program, "counters", lambda: {"nets.tail.fused": 3,
                                                      "nets.tail.plain": 1})
    assert _metric("tail_fused_share.restore", None) == 75.0
    monkeypatch.setattr(program, "counters", lambda: {"nets.tail.fused": 4})
    assert _metric("tail_fused_share.restore", None) == 100.0
    monkeypatch.setattr(program, "counters", lambda: {"nets.epilogue.fused": 4})
    assert _metric("tail_fused_share.restore", None) is None


def test_tail_fused_share_without_the_registry(monkeypatch):
    """A program without ``utils.trace`` reads null."""
    monkeypatch.setitem(sys.modules, "elvis_tpu_torch.utils.trace", None)
    assert _metric("tail_fused_share.restore", None) is None
