"""The port's instruments (``elvis_tpu_torch.utils.trace``): spans that cost
nothing with no profiler running and nest as documented under one, in the
Chrome trace the benchmark reads; the counter registry that holds the
kernels' launch and upload counts and the codec's frames and bytes."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elvis_tpu_torch.codec.nvc import codec as nvc
from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x, progressive_restore
from elvis_tpu_torch.scoring import (get_saliency_fn, importance_scores, removability_scores,
                                     saliency_to_block_mask, spatial_temporal_complexity)
from elvis_tpu_torch.scoring.saliency import _REGISTRY
from elvis_tpu_torch.utils.trace import counter, counters, span

N, H, W, GOP = 3, 32, 48, 2
PLANES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clip(n=N, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        base = 128 + 60 * np.sin(2 * np.pi * (xx + 3 * t) / 32) + 40 * np.cos(2 * np.pi * yy / 24)
        img = np.stack([base, np.roll(base, 3, axis=1), np.roll(base, -2, axis=0)], axis=-1)
        frames.append(np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8))
    return torch.from_numpy(np.stack(frames))


def _spans(fn, tmp_path):
    """Run ``fn`` under a CPU profile; the program's spans in its Chrome
    trace as ``[(name, start_us, end_us)]``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _all_inside(children, parents):
    return all(any(_inside(c, p) for p in parents) for c in children)


def test_span_is_one_shared_no_op_with_no_profiler_running():
    assert not torch.autograd._profiler_enabled()
    off = span("nvc.encode")
    assert off is span("restore.upsample")
    assert isinstance(off, contextlib.nullcontext)
    with off, off:  # re-entrant: spans nest
        pass


def test_span_records_under_the_profiler(tmp_path):
    def fn():
        assert span("a") is not span("b")
        with span("a"):
            with span("b"):
                torch.ones(2).sum()

    spans = _spans(fn, tmp_path)
    assert [s[0] for s in spans if s[0] in ("a", "b")] == ["a", "b"]
    assert _inside(_named(spans, "b")[0], _named(spans, "a")[0])


def test_no_span_reaches_a_later_profile(tmp_path):
    clip = _clip()
    nvc.encode(clip, qp=30, gop=GOP, device="cpu")  # no profiler: records nothing
    spans = _spans(lambda: torch.ones(2).sum(), tmp_path)
    assert not [s for s in spans if s[0].startswith("nvc.")]


@pytest.fixture(scope="module")
def coded():
    clip = _clip()
    return clip, nvc.encode(clip, qp=30, gop=GOP, device="cpu")


def test_encode_spans_nest(coded, tmp_path):
    clip, want = coded
    got = []
    spans = _spans(lambda: got.append(nvc.encode(clip, qp=30, gop=GOP, device="cpu")),
                   tmp_path)
    assert got == [want]
    top = _named(spans, "nvc.encode")
    assert len(top) == 1
    for name in ("nvc.encode.planes", "nvc.encode.download", "nvc.encode.pack"):
        assert len(_named(spans, name)) == 1 and _all_inside(_named(spans, name), top), name
    planes = _named(spans, "nvc.encode.planes")
    intra_frames = sum(1 for t in range(N) if t % GOP == 0)
    intra, inter = _named(spans, "nvc.encode.intra"), _named(spans, "nvc.encode.inter")
    assert len(intra) == intra_frames * PLANES
    assert len(inter) == (N - intra_frames) * PLANES
    assert _all_inside(intra + inter, planes)
    me = _named(spans, "nvc.encode.me")
    assert all(sum(_inside(m, i) for m in me) == 1 for i in inter)
    assert len(me) == len(inter)


def test_decode_spans_nest(coded, tmp_path):
    clip, stream = coded
    _, _, planes = nvc.read_stream(stream)
    spatial = sum(int((modes.reshape(N, -1) >= 4).any(axis=1).sum()) for _, modes, _ in planes)
    assert 0 < spatial < N * PLANES
    got = []
    spans = _spans(lambda: got.append(nvc.decode(stream, device="cpu")[0]), tmp_path)
    want, _ = nvc.decode(stream, device="cpu")
    assert torch.equal(got[0], want)
    top = _named(spans, "nvc.decode")
    assert len(top) == 1
    for name in ("nvc.decode.unpack", "nvc.decode.planes", "nvc.decode.rgb"):
        assert len(_named(spans, name)) == 1 and _all_inside(_named(spans, name), top), name
    intra, inter = _named(spans, "nvc.decode.intra"), _named(spans, "nvc.decode.inter")
    assert len(intra) == spatial and len(intra) + len(inter) == N * PLANES
    assert _all_inside(intra + inter, _named(spans, "nvc.decode.planes"))


def test_encode_counters_advance_by_frames_and_bytes(coded):
    clip, _ = coded
    before = counters()
    stream = nvc.encode(clip[:2], qp=34, gop=GOP, device="cpu")
    after = counters()
    assert after["nvc.encode.frames"] - before.get("nvc.encode.frames", 0) == 2
    assert after["nvc.encode.bytes"] - before.get("nvc.encode.bytes", 0) == len(stream)


def test_progressive_restore_spans(tmp_path):
    gen = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8, generator=gen)
    levels = torch.randint(0, 3, (2, 4, 4), generator=gen)
    levels[0, 0, 0] = 2
    got = []
    spans = _spans(lambda: got.append(progressive_restore(frames, levels, 8)), tmp_path)
    assert torch.equal(got[0], progressive_restore(frames, levels, 8, max_level=2))
    top = _named(spans, "restore.progressive")
    assert len(top) == 1
    assert len(_named(spans, "restore.levels")) == 1
    assert len(_named(spans, "restore.upsample")) == 2
    assert _all_inside(_named(spans, "restore.levels") + _named(spans, "restore.upsample"), top)

    # a given max_level reads nothing on the host
    spans = _spans(lambda: progressive_restore(frames, levels, 8, lanczos_upsample_2x,
                                               max_level=3), tmp_path)
    assert not _named(spans, "restore.levels")
    assert len(_named(spans, "restore.upsample")) == 3


@pytest.mark.parametrize("backend", ["center_prior", "motion_contrast"])
def test_scoring_spans(backend, tmp_path):
    clip = _clip().float()

    def score():
        cx = spatial_temporal_complexity(clip, 8)
        fg = saliency_to_block_mask(get_saliency_fn(backend)(clip), 8)
        removability_scores(cx.SC, cx.TC, fg)
        importance_scores(cx.SC, cx.TC, fg.float())

    spans = _spans(score, tmp_path)
    assert len(_named(spans, "score.complexity")) == 1
    assert len(_named(spans, "score.saliency")) == 1
    assert len(_named(spans, "score.fusion")) == 2


def test_every_saliency_backend_is_spanned():
    for name, fn in _REGISTRY.items():
        assert get_saliency_fn(name) is fn and fn.__wrapped__ is not fn, name
        assert fn.__name__ == fn.__wrapped__.__name__, name


def test_one_counter_registry():
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.kernels.block_transform import TABLE_UPLOADS

    assert LAUNCHES is counter("launches")
    assert TABLE_UPLOADS is counter("table_uploads")
    fam = counter("test_trace_family")
    assert counter("test_trace_family") is fam
    fam["x"] += 2
    fam["y.z"] += 1
    snap = counters()
    assert snap["test_trace_family.x"] == 2 and snap["test_trace_family.y.z"] == 1
    fam["x"] += 1
    assert snap["test_trace_family.x"] == 2  # a snapshot, not a view
    assert all(isinstance(v, int) for v in snap.values())
