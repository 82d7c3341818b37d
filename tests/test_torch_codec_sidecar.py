"""Port parity: strength-map and removal-mask sidecars, and the pipeline's
codec adapter (elvis_tpu_torch.codec against elvis_tpu.codec, on the CPU).

The lossless forms are held byte for byte or array for array. The video
sidecar is lossy: the port's decoded maps equal the JAX package's on at
least 99% of the entries, with a largest difference of 1 level.
"""

import numpy as np
import pytest
import torch

import elvis_tpu.codec as jcodec
import elvis_tpu_torch.codec as tcodec
from elvis_tpu.codec import dispatch as jdispatch
from elvis_tpu.codec import sidecar as js
from elvis_tpu_torch.codec import dispatch as tdispatch
from elvis_tpu_torch.codec import sidecar as ts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _level_maps(n=4, by=16, bx=16, seed=0):
    """Blobs of levels 0..3, as a degrade stage makes them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:by, 0:bx]
    maps = []
    for t in range(n):
        field = np.sin((xx + t) / 3.0) + np.cos(yy / 2.5) + rng.normal(0, 0.1, (by, bx))
        maps.append(np.clip(np.round((field + 2) * 0.75), 0, 3).astype(np.uint8))
    return np.stack(maps)


def test_in_memory_sidecar_bytes_equal_and_round_trip():
    maps = _level_maps()
    blob = ts.encode_strength_maps(maps)
    assert blob == js.encode_strength_maps(maps)
    np.testing.assert_array_equal(ts.decode_strength_maps(blob), maps)
    np.testing.assert_array_equal(js.decode_strength_maps(blob), maps)
    wide = _level_maps().astype(np.int32)  # other integer types are cast
    assert ts.encode_strength_maps(wide) == blob


def test_npz_sidecar_round_trip(tmp_path):
    maps = _level_maps()
    size = ts.save_strength_maps_npz(maps.astype(np.int32), str(tmp_path / "m.npz"))
    assert size == (tmp_path / "m.npz").stat().st_size
    assert size == js.save_strength_maps_npz(maps.astype(np.int32), str(tmp_path / "j.npz"))
    back = ts.load_strength_maps_npz(str(tmp_path / "m.npz"))
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, maps)
    np.testing.assert_array_equal(js.load_strength_maps_npz(str(tmp_path / "m.npz")), maps)


@pytest.mark.parametrize("rate", [None, 50000])
def test_video_sidecar_matches(tmp_path, rate):
    """At a QP (rate None) and at the pipeline's 50 kbit/s."""
    maps = _level_maps()
    kw = dict(framerate=30.0, target_bitrate=rate)
    size_t = ts.save_strength_maps_video(maps, str(tmp_path / "t.nvsv"), device="cpu", **kw)
    size_j = js.save_strength_maps_video(maps, str(tmp_path / "j.nvsv"), **kw)
    blob = (tmp_path / "t.nvsv").read_bytes()
    assert blob[:4] == b"NVSV" and size_t == len(blob)
    assert abs(size_t - size_j) <= 0.02 * size_j
    got = ts.load_strength_maps_video(str(tmp_path / "t.nvsv"), device="cpu")
    want = js.load_strength_maps_video(str(tmp_path / "j.nvsv"))
    assert got.shape == maps.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"rate {rate}: {size_t} and {size_j} bytes, {(diff == 0).mean():.2%} of entries equal, "
          f"{(got == maps).mean():.2%} equal to the source")
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    # each package reads the other's file
    cross = ts.load_strength_maps_video(str(tmp_path / "j.nvsv"), device="cpu")
    assert np.abs(cross.astype(int) - want.astype(int)).max() <= 1
    assert (cross == want).mean() >= 0.99


def test_video_sidecar_in_memory_round_trip():
    maps = _level_maps()
    stream, lo, hi = ts.encode_strength_maps_video(maps, qp=12, device="cpu")
    assert (lo, hi) == (float(maps.min()), float(maps.max()))
    back = ts.decode_strength_maps_video(stream, lo, hi, device="cpu")
    assert (back == maps).mean() >= 0.99  # a fine QP brings nearly every level back


def test_removal_masks_round_trip_with_motion_hints(tmp_path, rng):
    masks = rng.random((5, 6, 8)) < 0.3
    gmv = rng.integers(-20, 21, (4, 2)).astype(np.int16)
    dev = rng.integers(-3, 4, (4, 3, 4, 2)).astype(np.int8)
    path = str(tmp_path / "masks.npz")
    size = ts.save_removal_masks_npz(masks, path, motion_gmv=gmv, motion_dev=dev)
    assert size == js.save_removal_masks_npz(masks, str(tmp_path / "j.npz"), motion_gmv=gmv,
                                             motion_dev=dev)
    got, g, d = ts.load_removal_masks_npz(path, with_motion=True)
    np.testing.assert_array_equal(got, masks)
    np.testing.assert_array_equal(g, gmv)
    np.testing.assert_array_equal(d, dev)
    np.testing.assert_array_equal(js.load_removal_masks_npz(path), masks)
    ts.save_removal_masks_npz(masks, path)
    got, g, d = ts.load_removal_masks_npz(path, with_motion=True)
    assert g is None and d is None and (got == masks).all()


def test_presets_and_bitrate_model_equal():
    assert tcodec.QUALITY_PRESETS == jcodec.QUALITY_PRESETS
    for args in ((1920, 1080, 30), (640, 360, 25.0, 0.8)):
        assert tcodec.calculate_target_bitrate(*args) == jcodec.calculate_target_bitrate(*args)
    assert tcodec.calculate_target_bitrate(1920, 1080, 30) == 746496


def test_config_fields_carry_the_jax_defaults():
    from elvis_tpu.pipeline.config import ElvisConfig as JConfig
    from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig

    j, t = JConfig(), TConfig()
    for name in ("quality_factor", "target_bitrate_override", "strength_maps_use_npz",
                 "strength_maps_target_bitrate", "codec", "quality_preset", "nvc_b_frames",
                 "nvc_me_radius", "nvc_multi_ref", "nvc_deblock", "nvc_intra_pred"):
        assert getattr(t, name) == getattr(j, name), name


def _tiny_clip(rng, n=4, h=32, w=48):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([
        np.clip(np.stack([128 + 70 * np.sin((xx + 2 * t) / 5.0) * np.cos(yy / 7.0)] * 3, -1)
                + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8) for t in range(n)])


def test_pipeline_codec_matches(rng, tmp_path):
    """make_pipeline_codec('nvc'): encode at a target, encode_roi, decode."""
    frames = _tiny_clip(rng)
    knobs = dict(nvc_me_radius=2, nvc_multi_ref=True, nvc_deblock=False)
    tc_ = tdispatch.make_pipeline_codec("nvc", str(tmp_path), 48, 32, device="cpu", **knobs)
    jc_ = jdispatch.make_pipeline_codec("nvc", str(tmp_path), 48, 32, **knobs)
    assert isinstance(tc_, tdispatch.NvcPipelineCodec) and tc_.name == "nvc"
    assert tc_._kw == jc_._kw
    kw = dict(target_bitrate=80_000, framerate=30.0, gop=2)
    st, sj = tc_.encode(frames, **kw), jc_.encode(frames, **kw)
    assert abs(tc_._codec.probe(st).base_qp - jc_._codec.probe(sj).base_qp) <= 1
    assert abs(len(st) - len(sj)) <= 0.02 * len(sj)
    dt, dj = tc_.decode(sj), np.asarray(jc_.decode(sj))
    assert isinstance(dt, torch.Tensor) and dt.dtype == torch.uint8
    assert np.abs(dt.numpy().astype(int) - dj.astype(int)).max() <= 1
    importance = rng.random((4, 4, 6)).astype(np.float32)
    roi = dict(removability=1 - importance, importance=importance, block_size=8,
               roi_qp_range=10, **kw)
    rt, rj = tc_.encode_roi(torch.from_numpy(frames), **roi), jc_.encode_roi(frames, **roi)
    assert tc_._codec.probe(rt).has_roi and jc_._codec.probe(rj).has_roi
    # the ROI section (the final luma QP map) is the same map
    if tc_._codec.probe(rt).base_qp == jc_._codec.probe(rj).base_qp:
        from elvis_tpu_torch.codec.nvc.codec import read_stream
        np.testing.assert_array_equal(read_stream(rt)[1], read_stream(rj)[1])
    assert abs(len(rt) - len(rj)) <= 0.02 * len(rj)


def test_pipeline_codec_names():
    base = tdispatch.PipelineCodec()
    for call in (lambda: base.encode(None, target_bitrate=1, framerate=1.0, gop=0),
                 lambda: base.decode(b"")):
        with pytest.raises(NotImplementedError):
            call()
    for name in ("x265", "kvazaar", "svtav1"):
        with pytest.raises(NotImplementedError, match="not ported yet.*ROADMAP.md"):
            tdispatch.make_pipeline_codec(name, "", 64, 48, device="cpu")
    with pytest.raises(ValueError, match="unknown codec"):
        tdispatch.make_pipeline_codec("h264", "", 64, 48, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdispatch.make_pipeline_codec("nvc", "", 64, 48)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nothing under elvis_tpu_torch/ and not chip_smoke.py imports jax or
    elvis_tpu (docstrings may name them)."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "elvis_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "elvis_tpu"), (path, name)
