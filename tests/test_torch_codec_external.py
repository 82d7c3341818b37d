"""Port parity: the ROI files, the external encoder wrappers and the external
pipeline codecs (``elvis_tpu_torch.codec.{roi,external,dispatch}``) against
``elvis_tpu.codec.*``, and mp4 sources, on the CPU.

No encoder binary exists here, so the wrappers run under the JAX package's
shim (``ELVIS_TPU_FAKE_CODECS``), which records every argv and writes canned
outputs; the port honours the same variable byte for byte.

Tolerances:
  * kvazaar and SVT-AV1 ROI files: byte-equal (float64 / float32 numpy work
    in both packages; the SVT-AV1 regrid's float32 sums differ from XLA's
    in the last bit, which the truncation to 8 levels does not see here).
  * x265 qpfile: the same CTU, lines and tokens; each value within 1e-4 of
    JAX's (one unit of the fourth decimal) and at most 0.1% of the values
    differing. The CTU regrid's float32 sums run in PyTorch's order, XLA's
    CPU dot in its own (which depends on the shape): a value whose exact
    result sits on a rounding boundary of the fourth decimal may print one
    unit apart (ROADMAP.md §3).
  * argv chains: equal after the work directory and the temporary y4m
    names are replaced by placeholders.
  * the rate model's QP / CRF: equal, or within 1 where the two NVC probe
    streams differ in length (printed).
"""

import json
import math
import re

import numpy as np
import pytest
import torch

from elvis_tpu.codec import dispatch as jdispatch, external as jext, roi as jroi
from elvis_tpu_torch.codec import dispatch as tdispatch, external as text, roi as troi

SIZES = {"360p": (640, 360), "1080p": (1920, 1080), "2160p": (3840, 2160)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("b", [8, 16, 32])
def test_roi_files_equal_jax(size, b, tmp_path):
    """The three ROI writers on the same seeded maps, in both packages, at
    every CTU choice and both regrid directions."""
    w, h = SIZES[size]
    rng = np.random.default_rng(b * 7 + h)
    scores = rng.random((2, h // b, w // b)).astype(np.float32)
    importance = 1.0 - scores

    jq, tq = tmp_path / "j.qpfile", tmp_path / "t.qpfile"
    ctu = jroi.write_x265_qpfile(str(jq), scores, b, w, h)
    assert troi.write_x265_qpfile(str(tq), scores, b, w, h, device="cpu") == ctu
    assert troi.select_ctu_size(b, w, h) == ctu
    jl, tl = jq.read_text().splitlines(), tq.read_text().splitlines()
    rows, cols = math.ceil(h / ctu), math.ceil(w / ctu)
    assert len(tl) == len(jl) == 2
    differing = 0
    for jline, tline in zip(jl, tl):
        jt, tt = jline.split(" "), tline.split(" ")
        assert tt[:3] == jt[:3] and len(tt) == len(jt) == 3 + rows * cols
        for a, c in zip(jt[3:], tt[3:]):
            ja, ta = a.rsplit(",", 1), c.rsplit(",", 1)
            assert ta[0] == ja[0]
            assert abs(float(ta[1]) - float(ja[1])) <= 1e-4 + 1e-9, (a, c)
            differing += ta[1] != ja[1]
    print(f"{size} b={b} ctu={ctu}: {differing} of {2 * rows * cols} qpfile values differ")
    assert differing <= 0.001 * 2 * rows * cols

    for qp, r in ((20, 15), (48, 10)):
        jk, tk = tmp_path / f"j{qp}.bin", tmp_path / f"t{qp}.bin"
        jroi.write_kvazaar_roi(str(jk), importance, base_qp=qp, qp_range=r)
        troi.write_kvazaar_roi(str(tk), importance, base_qp=qp, qp_range=r)
        assert tk.read_bytes() == jk.read_bytes()
    js, ts = tmp_path / "j.txt", tmp_path / "t.txt"
    jroi.write_svtav1_roi(str(js), importance, base_crf=58, qp_range=12, width=w, height=h)
    troi.write_svtav1_roi(str(ts), importance, base_crf=58, qp_range=12, width=w, height=h,
                          device="cpu")
    assert ts.read_bytes() == js.read_bytes()


def test_qp_offsets_and_ctu_choice_equal_jax():
    rng = np.random.default_rng(3)
    s = rng.random((3, 5, 7)).astype(np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(troi.qp_offsets_from_scores(s), jroi.qp_offsets_from_scores(s))
    for b in (4, 8, 12, 16, 24, 32, 48, 64, 128):
        for w, h in ((640, 360), (1920, 1080), (3840, 2160), (7680, 4320)):
            assert troi.select_ctu_size(b, w, h) == jroi.select_ctu_size(b, w, h)


def _fake_env(monkeypatch, d):
    monkeypatch.setenv("ELVIS_TPU_FAKE_CODECS", str(d))
    return d


def _argv(fake, work, placeholder="<WORK>"):
    """The recorded argv lines with the work dir and tmp y4m names replaced."""
    log = fake / "argv.jsonl"
    lines = log.read_text().splitlines() if log.exists() else []
    out = []
    for line in lines:
        line = line.replace(str(work), placeholder)
        out.append(re.sub(r'"[^"]*/tmp[^"/]*\.y4m"', '"<Y4M>"', line))
    return out


def _frames(n=4, h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("wrapper", ["x265", "x265_lossless", "kvazaar", "svtav1"])
def test_wrapper_argv_equal_jax_under_the_shim(wrapper, tmp_path, monkeypatch):
    frames = _frames()
    imp = np.random.default_rng(1).random((4, 6, 8)).astype(np.float32)
    chains = {}
    for pkg, mod in (("jax", jext), ("port", text)):
        work = tmp_path / pkg
        work.mkdir()
        fake = _fake_env(monkeypatch, tmp_path / f"fake_{pkg}")
        assert mod.is_available("x265-or-anything")
        out = str(work / "clip.mp4")
        if wrapper.startswith("x265"):
            rate = None if wrapper == "x265_lossless" else 150_000
            mod.encode_video_x265(str(work / "frames"), out, 30.0, 64, 48, target_bitrate=rate,
                                  preset="slow", ctu=16, qpfile=str(work / "q.qpfile"))
        elif wrapper == "kvazaar":
            mod.encode_kvazaar(frames, out, 30.0, qp=37, qp_range=12, importance_scores=imp,
                               gop=30)
        else:
            kw = {} if pkg == "jax" else {"device": "cpu"}
            mod.encode_svtav1(frames, out, 30.0, crf=44, qp_range=12, importance_scores=imp,
                              gop=30, **kw)
        assert open(out, "rb").read() == b"FAKEclip.mp4"
        chains[pkg] = _argv(fake, work)
    assert chains["port"] == chains["jax"] and chains["jax"]
    if wrapper == "x265":
        p1, p2 = (json.loads(x) for x in chains["jax"])
        assert "qpfile" not in " ".join(p1) and "qpfile=<WORK>/q.qpfile" in " ".join(p2)
        assert (p1[p1.index("-minrate") + 1], p1[p1.index("-maxrate") + 1]) == ("135000",
                                                                                "165000")


def test_decode_video_ffmpeg_shim_and_missing_binary(tmp_path, monkeypatch):
    fake = _fake_env(monkeypatch, tmp_path / "fake")
    got = text.decode_video_ffmpeg("x.mp4", 64, 48)
    want = jext.decode_video_ffmpeg("x.mp4", 64, 48)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, 48, 64, 3) and got.dtype == np.uint8
    assert _argv(fake, tmp_path) == ['["ffmpeg-decode", "x.mp4"]'] * 2
    monkeypatch.delenv("ELVIS_TPU_FAKE_CODECS")
    monkeypatch.setenv("PATH", str(tmp_path))  # no binary on the path
    for mod in (jext, text):
        with pytest.raises(mod.CodecUnavailable, match="ffmpeg"):
            mod.decode_video_ffmpeg("x.mp4", 64, 48)
        with pytest.raises(mod.CodecUnavailable, match="'kvazaar' not found"):
            mod.encode_kvazaar(_frames(2), str(tmp_path / "k.mp4"), 30.0)


def _codec_pair(name, tmp_path, **kw):
    j = jdispatch.make_pipeline_codec(name, str(tmp_path / "jax"), 64, 48, **kw)
    t = tdispatch.make_pipeline_codec(name, str(tmp_path / "port"), 64, 48, device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("name", ["nvc", "x265", "kvazaar", "svtav1"])
def test_pipeline_codec_argv_equal_jax(name, tmp_path, monkeypatch):
    """Each pipeline codec's plain and ROI encode and its decode under the
    shim: the same argv chain, the same ROI file where one stays (the x265
    qpfile), and decode returns the input frames (a lossless stash), as a
    tensor on the codec's device."""
    frames = _frames()
    rng = np.random.default_rng(2)
    imp = rng.random((4, 6, 8)).astype(np.float32)
    roi = dict(removability=1 - imp, importance=imp, block_size=8, roi_qp_range=10)
    # kvazaar and SVT-AV1 at the preset's QP / CRF (the rate model has its own test)
    rate = 200_000 if name in ("nvc", "x265") else None
    kw = dict(target_bitrate=rate, framerate=30.0, gop=30)
    chains, qpfiles = {}, {}
    for pkg in ("jax", "port"):
        fake = _fake_env(monkeypatch, tmp_path / f"fake_{pkg}")
        codec = _codec_pair(name, tmp_path, preset="slow", pix_fmt="yuv444p",
                            quality="high")[pkg == "port"]
        x = torch.from_numpy(frames) if pkg == "port" else frames
        s1 = codec.encode(x, **kw)
        s2 = codec.encode_roi(x, **roi, **kw)
        for s in (s1, s2):
            dec = codec.decode(s)
            if pkg == "port":
                assert isinstance(dec, torch.Tensor) and dec.device.type == "cpu"
                dec = dec.numpy()
            if name == "nvc":
                assert dec.shape == frames.shape
            else:
                np.testing.assert_array_equal(dec, frames)
        chains[pkg] = _argv(fake, tmp_path / pkg)
        qpfiles[pkg] = sorted(p.read_text() for p in (tmp_path / pkg).glob("*.qpfile"))
    assert chains["port"] == chains["jax"]
    assert qpfiles["port"] == qpfiles["jax"]
    assert bool(chains["jax"]) == (name != "nvc")
    if name == "x265":
        assert len(qpfiles["jax"]) == 1 and len(chains["jax"]) == 4  # 2 encodes x 2 passes
        assert "ctu=16:qpfile=<WORK>/x265_003.qpfile" in chains["jax"][3]
        assert "yuv444p" in chains["jax"][0] and '"slow"' in chains["jax"][0]
    if name == "kvazaar":
        assert '"-q", "30"' in chains["jax"][0] and '"--roi"' in chains["jax"][3]


def test_fake_stash_crosses_both_ways(tmp_path, monkeypatch):
    frames = _frames(3, seed=5)
    assert tdispatch._FAKE_MAGIC == jdispatch._FAKE_MAGIC == b"ELVISFAKE1"
    np.testing.assert_array_equal(jdispatch._fake_unpack(tdispatch._fake_pack(frames)), frames)
    np.testing.assert_array_equal(tdispatch._fake_unpack(jdispatch._fake_pack(frames)), frames)
    assert tdispatch._fake_unpack(b"not a stash") is None
    _fake_env(monkeypatch, tmp_path / "fake")
    j, t = _codec_pair("kvazaar", tmp_path)
    kw = dict(target_bitrate=None, framerate=30.0, gop=30)
    np.testing.assert_array_equal(t.decode(j.encode(frames, **kw)).numpy(), frames)
    np.testing.assert_array_equal(j.decode(t.encode(torch.from_numpy(frames), **kw)), frames)


def test_rate_model_qp_and_crf_equal_jax():
    """The probe encode at QP 32 through each package's NVC encoder and the
    QP / CRF law; the cache key is JAX's (shape, exact int64 sum, target)."""
    from elvis_tpu.codec.nvc.codec import encode as jencode
    from elvis_tpu_torch.codec.nvc.codec import encode as tencode

    frames = np.round(np.linspace(0, 255, 6 * 48 * 64 * 3)).reshape(6, 48, 64, 3)
    frames = (frames + _frames(6, seed=9) // 8).astype(np.uint8)
    jm, tm = jdispatch._RateModel(), tdispatch._RateModel("cpu")
    jlen = len(jencode(frames, qp=32, framerate=30.0))
    tlen = len(tencode(torch.from_numpy(frames), qp=32, framerate=30.0, device="cpu"))
    for target in (50_000, 400_000, 3_000_000):
        jq = jm.hevc_qp(frames, target, 30.0)
        tq = tm.hevc_qp(torch.from_numpy(frames), target, 30.0)
        jc, tc = jm.av1_crf(frames, target, 30.0), tm.av1_crf(frames, target, 30.0)
        print(f"target {target}: QP {tq} / {jq}, CRF {tc} / {jc}; probe bytes {tlen} / {jlen}")
        tol = 0 if tlen == jlen else 1
        assert abs(tq - jq) <= tol and abs(tc - jc) <= tol
    assert list(tm._cache) == list(jm._cache)


def test_make_pipeline_codec_names_equal_jax(tmp_path):
    for name in ("nvc", "x265", "kvazaar", "svtav1"):
        j, t = _codec_pair(name, tmp_path)
        assert t.name == j.name == name
    for mod, kw in ((jdispatch, {}), (tdispatch, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"unknown codec 'h264'; choose from "
                                             r"\['kvazaar', 'nvc', 'svtav1', 'x265'\]"):
            mod.make_pipeline_codec("h264", str(tmp_path), 64, 48, **kw)


@pytest.mark.parametrize("shim", [True, False])
def test_mp4_source_equals_jax(shim, tmp_path, monkeypatch):
    """An mp4 source reads through ffmpeg: under the shim one black frame,
    resized as any source is; without ffmpeg JAX's FileNotFoundError."""
    from elvis_tpu.pipeline.io import load_clip as jload
    from elvis_tpu_torch.pipeline.io import load_clip as tload

    if shim:
        _fake_env(monkeypatch, tmp_path / "fake").mkdir()
        (jf, jfps), (tf, tfps) = jload("clip.mp4", 64, 48), tload("clip.mp4", 64, 48,
                                                                device="cpu")
        np.testing.assert_array_equal(tf, jf)
        assert tf.shape == (1, 48, 64, 3) and tfps == jfps == 30.0
        return
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError) as jerr:
        jload("clip.mp4", 64, 48)
    with pytest.raises(FileNotFoundError) as terr:
        tload("clip.mp4", 64, 48, device="cpu")
    assert str(terr.value) == str(jerr.value)
