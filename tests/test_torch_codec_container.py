"""Port parity: the host half of the codec, byte for byte. Levels, modes and
vectors from the JAX encoder go through the port's container writer and must
give the JAX package's stream; the port's reader must bring them back."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.codec.nvc import codec as jc
from elvis_tpu_torch.codec.nvc import codec as tc

N, H, W = 6, 48, 64
QP = 28


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
    return np.stack(frames)


def _roi(seed=1):
    return np.random.default_rng(seed).integers(-10, 11, (N, H // 8, W // 8)).astype(np.int8)


CASES = {  # name -> (with ROI, b_frames, gop)
    "plain": (False, False, 0),
    "roi": (True, False, 3),
    "b_frames": (False, True, 4),
    "roi_b_frames": (True, True, 0),
}


@pytest.fixture(scope="module")
def jax_planes():
    """Per case: the JAX stream, and the JAX encoder's arrays behind it."""
    out = {}
    frames = _clip()
    for name, (with_roi, b_frames, gop) in CASES.items():
        roi = _roi() if with_roi else None
        qp_y = jc._qp_maps(N, H // 8, W // 8, QP, roi)
        qp_c = jc._chroma_qp(qp_y)
        arrays = [np.asarray(a) for a in jc._encode_planes_jit(
            jnp.asarray(frames), jnp.asarray(qp_y), jnp.asarray(qp_c), gop, 4, 1, True,
            b_frames, 2, False, True, True)]
        planes = [(jc._unpack_levels(arrays[i]), arrays[i + 1], arrays[i + 2])
                  for i in (0, 3, 6)]
        stream = jc.encode(frames, qp=QP, framerate=25.0, roi_delta_qp=roi, gop=gop,
                           b_frames=b_frames)
        out[name] = (stream, planes, qp_y if with_roi else None)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_container_writer_gives_the_jax_stream(jax_planes, name):
    stream, planes, qp_y = jax_planes[name]
    _, b_frames, gop = CASES[name]
    got = tc.write_stream(planes, width=W, height=H, qp=QP, framerate=25.0, gop=gop,
                          qp_y=qp_y, deblock=True, b_frames=b_frames, b_qp_offset=2)
    assert got == stream


@pytest.mark.parametrize("name", list(CASES))
def test_container_reader_brings_the_arrays_back(jax_planes, name):
    stream, planes, qp_y = jax_planes[name]
    header, qp_read, planes_read = tc.read_stream(stream)
    assert header == jc._read_header(stream) == tc._read_header(stream)
    np.testing.assert_array_equal(qp_read, qp_y if qp_y is not None
                                  else np.full((N, H // 8, W // 8), QP))
    for (lv, md, mv), (lv2, md2, mv2) in zip(planes, planes_read):
        np.testing.assert_array_equal(lv2, lv)
        np.testing.assert_array_equal(md2, md)
        np.testing.assert_array_equal(mv2, mv)
        assert lv2.dtype == np.int16 and md2.dtype == np.int8 and mv2.dtype == np.int8
    np.testing.assert_array_equal(tc.luma_modes(stream), jc.luma_modes(stream))
    assert tc.NvcCodec("cpu").probe(stream) == tc.NvcStream(
        **vars(jc.NvcCodec().probe(stream)))
    assert tc.section_backends(stream) == [0] * ((qp_y is not None) + 9)


def test_qp_maps_and_chroma_qp_match(rng):
    for roi in (None, _roi(), rng.integers(-20, 21, (N, 12, 16)).astype(np.float32),
                rng.integers(-20, 21, (N, 3, 4)).astype(np.int8)):
        want = jc._qp_maps(N, 6, 8, 30, roi)
        got = tc._qp_maps(N, 6, 8, 30, roi)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tc._chroma_qp(got), jc._chroma_qp(want))


def test_dc_dpcm_round_trip_and_overflow(rng):
    zz = rng.integers(-300, 301, (24, 64)).astype(np.int16)
    want = jc._dc_dpcm(zz, 12)
    got = tc._dc_dpcm(zz, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tc._dc_dpcm_inverse(got.copy(), 12), zz)
    zz[0, 0], zz[1, 0] = 32767, -32767  # a delta that overflows int16: stored plain
    assert tc._dc_dpcm(zz, 12) is None and jc._dc_dpcm(zz, 12) is None


def test_pad_to_and_small_helpers(rng):
    x = rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tc._pad_to(torch.from_numpy(x), 16).numpy(), jc._pad_to(x, 16))
    same = torch.from_numpy(x[:, :32, :48])
    assert tc._pad_to(same, 16) is same
    mvs = np.zeros((2, 3, 4, 2), np.int8)
    assert tc._reach_of(mvs) == jc._reach_of(mvs) == 1
    mvs[0, 0, 0] = (-17, 33)
    assert tc._reach_of(mvs) == jc._reach_of(mvs) == 3
    for args in ((8, 1080, 1920, None), (100, 48, 64, None), (10, 48, 64, 1), (10, 48, 64, 5)):
        assert tc._chunk_frames_for(*args) == jc._chunk_frames_for(*args)
    assert tc._pack_section(1, b"abc") == jc._pack_section(1, b"abc")


def test_old_header_versions_still_parse():
    import struct

    v2 = b"NVC1" + struct.pack("<BBHHHfbH", 2, 1, 64, 48, 6, 30.0, 28, 3)
    v3 = b"NVC1" + struct.pack("<BBHHHfbHB", 3, 2, 64, 48, 6, 30.0, 28, 3, 3)
    for stream in (v2, v3):
        assert tc._read_header(stream) == jc._read_header(stream)
    assert tc._read_header(v2)[8] == 0 and tc._read_header(v3)[8:10] == (3, True)
