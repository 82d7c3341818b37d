"""The readers of the program's own spans and counters: on small Chrome
traces made by hand (program spans nested under the benchmark's
``bench.encode`` / ``bench.decode``, kernels counted per span, the restore
loop's device time apart from its upsamplers, nothing where the spans are
missing), on a real CPU profile of the port's encode, and on the card (marked:
the device-side copies of the spans stay out of the device operations)."""

import json
from types import SimpleNamespace

import pytest

from port_bench.harness import spec, trace

TID = {"pid": 1, "tid": 7}
DEV = {"pid": 0, "tid": 1}


def _span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, **TID)


def _launch(corr, ts, name="my_kernel", start=None, dur=5, cat="kernel"):
    """A runtime call at ``ts`` and the device operation it launched."""
    return [dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=1,
                 args={"correlation": corr}, **TID),
            dict(ph="X", cat=cat, name=name, ts=ts + 2 if start is None else start, dur=dur,
                 args={"correlation": corr}, **DEV)]


def _read(tmp_path, events, segments, frames):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read_chrome_trace(str(path), segments=segments, frames=frames)


def _metric(name, t):
    return spec.metric_reader(name).read(SimpleNamespace(trace=t))


def _encode_trace(tmp_path):
    """One segment of 8 frames: scoring, then ``bench.encode`` around the
    program's encode spans. Kernels: 2 + 1 in the scores, 3 in the intra
    frame, 2 in the inter frame (1 of them in its motion search), a download."""
    ev = [_span("bench.window", 0, 1000),
          _span("score.complexity", 10, 20), _span("score.saliency", 30, 20),
          _span("score.fusion", 50, 20),
          _span("bench.encode", 100, 800), _span("nvc.encode", 110, 780),
          _span("nvc.encode.planes", 120, 380),
          _span("nvc.encode.intra", 130, 70), _span("nvc.encode.inter", 210, 190),
          _span("nvc.encode.me", 220, 80),
          _span("nvc.encode.download", 500, 50), _span("nvc.encode.pack", 560, 320)]
    ev += _launch(1, 12, dur=3) + _launch(2, 35, dur=4) + _launch(3, 55, dur=2)
    ev += _launch(4, 135) + _launch(5, 150) + _launch(6, 190)
    ev += _launch(7, 230) + _launch(8, 350)
    ev += _launch(9, 510, name="Memcpy DtoH", cat="gpu_memcpy", dur=30)
    # the device-side copy of a span, which record_function adds on a card
    ev.append(dict(ph="X", cat="gpu_user_annotation", name="nvc.encode.intra", ts=137,
                   dur=60, **DEV))
    return _read(tmp_path, ev, segments=1, frames=8)


def test_program_spans_nest_under_the_benchmarks_own(tmp_path):
    t = _encode_trace(tmp_path)
    assert t.spans["nvc.encode.pack"] == [(560.0, 880.0)]
    assert {"bench.encode", "nvc.encode", "nvc.encode.me", "score.fusion"} <= set(t.spans)
    assert all(op.cat in trace.DEVICE_CATS for op in t.ops)
    assert len(t.ops) == 9  # the span's device-side copy is no device operation
    # the outer metric reads the same with the spans inside it
    assert _metric("nvc_launches_per_frame", t) == 5 / 8
    # an idle gap goes to the innermost range at its middle: the longest, from
    # the download's end to the window's, is the pack's, not bench.encode's
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["nvc.encode.pack", pytest.approx((1000 - 542) * 1e-6)]
    assert "bench.encode" not in dict(gaps)


def test_encode_readers(tmp_path):
    t = _encode_trace(tmp_path)
    assert _metric("nvc_pack_ms.encode", t) == 320 / 1e3 / 8
    assert _metric("nvc_intra_launches_per_frame", t) == 3 / 8
    assert _metric("score_device_ms.encode", t) == (3 + 4 + 2) / 1e3


def test_launches_are_counted_per_span(tmp_path):
    t = _encode_trace(tmp_path)
    assert len(t.launched_within("nvc.encode.intra")) == 3
    assert len(t.launched_within("nvc.encode.inter")) == 2
    assert len(t.launched_within("nvc.encode.me")) == 1
    assert [op.name for op in t.launched_within("nvc.encode.download")] == ["Memcpy DtoH"]
    assert t.launched_within("nvc.encode.pack") == []


def _client_trace(tmp_path, with_program_spans=True):
    """One segment of 8 frames decoded: unpack on the host, 3 kernels in the
    plane decodes, 1 in the colour conversion, then the restore."""
    ev = [_span("bench.window", 0, 1000), _span("bench.decode", 100, 800)]
    if with_program_spans:
        ev += [_span("nvc.decode", 110, 780), _span("nvc.decode.unpack", 120, 280),
               _span("nvc.decode.planes", 400, 400), _span("nvc.decode.intra", 410, 100),
               _span("nvc.decode.inter", 520, 200), _span("nvc.decode.rgb", 800, 80)]
    ev += _launch(1, 420) + _launch(2, 530) + _launch(3, 600) + _launch(4, 810)
    ev += _launch(5, 950, name="conv")
    return _read(tmp_path, ev, segments=1, frames=8)


def test_client_readers(tmp_path):
    t = _client_trace(tmp_path)
    assert _metric("nvc_unpack_ms.client", t) == 280 / 1e3 / 8
    assert _metric("nvc_decode_launches_per_frame.client", t) == 4 / 8
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["nvc.decode.unpack", pytest.approx(422e-6)]  # from the window's start
    assert "bench.decode" not in dict(gaps)


def _restore_trace(tmp_path, with_program_spans=True):
    """Two segments: each a loop with the host read of the levels (one
    kernel), two upsample stages (a net kernel each) and the loop's own
    resizes, re-injection and rounding (three kernels)."""
    ev = [_span("bench.window", 0, 2000)]
    loop_us = 0
    for s, base in enumerate((0, 1000)):
        if with_program_spans:
            ev += [_span("restore.progressive", base + 100, 800),
                   _span("restore.levels", base + 110, 10),
                   _span("restore.upsample", base + 200, 200),
                   _span("restore.upsample", base + 500, 200)]
        c = 10 * s
        ev += _launch(c + 1, base + 112, name="reduce", dur=1)
        ev += _launch(c + 2, base + 150, name="area", dur=7)
        ev += _launch(c + 3, base + 250, name="net", dur=100)
        ev += _launch(c + 4, base + 450, name="where", dur=3)
        ev += _launch(c + 5, base + 550, name="net", dur=100)
        ev += _launch(c + 6, base + 800, name="round", dur=2)
        loop_us += 1 + 7 + 3 + 2
    return _read(tmp_path, ev, segments=2, frames=16), loop_us


def test_loop_ms_leaves_out_the_upsamplers(tmp_path):
    t, loop_us = _restore_trace(tmp_path)
    assert _metric("loop_ms.restore", t) == loop_us / 1e3 / 2
    # the outer metric reads the same with the spans in
    bare, _ = _restore_trace(tmp_path, with_program_spans=False)
    assert _metric("nonconv_ms.restore", t) == _metric("nonconv_ms.restore", bare)


def test_none_where_the_spans_are_missing(tmp_path):
    """A program without the spans: every reader finds nothing."""
    window = _read(tmp_path, [_span("bench.window", 0, 100), _span("bench.encode", 10, 80)]
                   + _launch(1, 20), segments=1, frames=8)
    bare_client = _client_trace(tmp_path, with_program_spans=False)
    bare_restore, _ = _restore_trace(tmp_path, with_program_spans=False)
    for name, t in [("nvc_pack_ms.encode", window), ("nvc_intra_launches_per_frame", window),
                    ("score_device_ms.encode", window), ("nvc_unpack_ms.client", bare_client),
                    ("nvc_decode_launches_per_frame.client", bare_client),
                    ("loop_ms.restore", bare_restore)]:
        assert _metric(name, t) is None, name
        assert _metric(name, None) is None, name


def test_bytes_per_frame_reads_the_counters(monkeypatch):
    import elvis_tpu_torch.utils.trace as program

    run = SimpleNamespace(trace=None)
    monkeypatch.setattr(program, "counters", lambda: {"nvc.encode.frames": 16,
                                                      "nvc.encode.bytes": 8000})
    assert spec.metric_reader("nvc_bytes_per_frame.encode").read(run) == 500
    monkeypatch.setattr(program, "counters", lambda: {})
    assert spec.metric_reader("nvc_bytes_per_frame.encode").read(run) is None


def test_bytes_per_frame_without_the_registry(monkeypatch):
    """A program without ``utils.trace`` reads null."""
    import sys

    monkeypatch.setitem(sys.modules, "elvis_tpu_torch.utils.trace", None)
    run = SimpleNamespace(trace=None)
    assert spec.metric_reader("nvc_bytes_per_frame.encode").read(run) is None


def _profiled_encodes(device):
    import torch

    from elvis_tpu_torch.codec.nvc import codec as nvc
    from elvis_tpu_torch.utils.trace import counters

    gen = torch.Generator().manual_seed(5)
    clip = torch.randint(0, 256, (4, 32, 48, 3), dtype=torch.uint8, generator=gen).to(device)
    before = counters()
    t = trace.profile_steps(lambda k: nvc.encode(clip, qp=30, gop=4, device=device), 2, 4)
    after = counters()
    return t, after["nvc.encode.bytes"] - before.get("nvc.encode.bytes", 0)


def test_the_ports_spans_reach_the_trace_reader():
    """A real profile of the port's encode on the CPU: the program's spans
    are read as spans of the driving thread, and the readers find them."""
    t, nbytes = _profiled_encodes("cpu")
    assert len(t.spans["nvc.encode"]) == 2 and len(t.spans["nvc.encode.pack"]) == 2
    assert len(t.spans["nvc.encode.intra"]) == 2 * 3 and len(t.spans["nvc.encode.me"]) == 2 * 9
    assert _metric("nvc_pack_ms.encode", t) > 0
    assert _metric("nvc_intra_launches_per_frame", t) == 0  # no device here
    assert nbytes > 0


@pytest.mark.gpu
def test_on_the_card_span_copies_stay_out_of_the_device_operations(cuda):
    t, _ = _profiled_encodes(cuda)
    assert all(op.cat in trace.DEVICE_CATS for op in t.ops)
    kernels = [op for op in t.launched_within("nvc.encode") if op.cat == "kernel"]
    intra = [op for op in t.launched_within("nvc.encode.intra") if op.cat == "kernel"]
    assert 0 < len(intra) < len(kernels)
    assert _metric("nvc_intra_launches_per_frame", t) == len(intra) / 8
