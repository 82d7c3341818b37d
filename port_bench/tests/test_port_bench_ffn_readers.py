"""The readers of E2FGVI-HQ's feed-forward: ``ffn_ms.inpaint`` on small
Chrome traces made by hand (the device time launched inside ``e2fgvi.ffn``,
per segment, nothing where the span is missing) and
``ffn_fused_share.inpaint`` on the program's ``nets`` counters (nothing
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


def _ffn_trace(tmp_path, with_spans):
    """Two segments, each a transformer block: attention, then the
    feed-forward's span around fc1, the fold kernel and fc2, and a residual
    add after it."""
    ev = [_span("bench.window", 0, 2000)]
    for s, base in enumerate((0, 1000)):
        if with_spans:
            ev.append(_span("e2fgvi.attention", base + 50, 300))
            ev.append(_span("e2fgvi.ffn", base + 400, 300))
        c = 10 * s
        ev += _launch(c + 1, base + 100, "attention", 200)
        ev += _launch(c + 2, base + 410, "fc1_gemm", 60)
        ev += _launch(c + 3, base + 500, "ffn_fold_gelu", 30)
        ev += _launch(c + 4, base + 600, "fc2_gemm", 50)
        ev += _launch(c + 5, base + 800, "add", 5)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(str(path), segments=2, frames=16)


def test_ffn_ms_reads_the_feed_forward_spans(tmp_path):
    """``ffn_ms.inpaint`` sums what launched inside the feed-forward spans,
    per segment; without the spans, or without a trace, it reads None."""
    assert _metric("ffn_ms.inpaint", _ffn_trace(tmp_path, True)) == (60 + 30 + 50) / 1e3
    assert _metric("ffn_ms.inpaint", _ffn_trace(tmp_path, False)) is None
    assert _metric("ffn_ms.inpaint", None) is None


def test_ffn_fused_share_reads_the_counters(monkeypatch):
    import elvis_tpu_torch.utils.trace as program

    monkeypatch.setattr(program, "counters", lambda: {"nets.ffn.fused": 3,
                                                      "nets.ffn.plain": 1})
    assert _metric("ffn_fused_share.inpaint", None) == 75.0
    monkeypatch.setattr(program, "counters", lambda: {"nets.ffn.fused": 112})
    assert _metric("ffn_fused_share.inpaint", None) == 100.0
    monkeypatch.setattr(program, "counters", lambda: {"nets.tail.fused": 4})
    assert _metric("ffn_fused_share.inpaint", None) is None


def test_ffn_fused_share_without_the_registry(monkeypatch):
    """A program without ``utils.trace`` reads null."""
    monkeypatch.setitem(sys.modules, "elvis_tpu_torch.utils.trace", None)
    assert _metric("ffn_fused_share.inpaint", None) is None
