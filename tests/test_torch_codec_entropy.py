"""Port parity: the range coder binding (elvis_tpu_torch.codec.nvc.entropy
against elvis_tpu.codec.nvc.entropy). The port builds its own copy of the
JAX package's source, so payloads are held equal byte for byte."""

import zlib
from pathlib import Path

import numpy as np
import pytest

from elvis_tpu.codec.nvc import entropy as je
from elvis_tpu_torch.codec.nvc import entropy as te

ROOT = Path(__file__).resolve().parents[1]


def test_range_coder_source_is_the_reference_source():
    ours = ROOT / "elvis_tpu_torch/codec/nvc/csrc/rangecoder.cpp"
    theirs = ROOT / "elvis_tpu/codec/nvc/csrc/rangecoder.cpp"
    assert ours.read_bytes() == theirs.read_bytes()
    assert te._CSRC == ours
    # built from that source into the port's own build directory
    assert te.native_available()
    assert te._lib_path().parent == ROOT / "elvis_tpu_torch" / "_build"
    assert te._lib_path().is_file()


def _coeff_cases(rng):
    sparse = np.zeros((200, 64), np.int16)
    mask = rng.random(sparse.shape) < 0.05
    sparse[mask] = rng.integers(-40, 41, mask.sum())
    dense = rng.integers(-300, 301, (50, 64)).astype(np.int16)
    extremes = np.zeros((4, 64), np.int16)
    extremes[0, :4] = (32767, -32767, -32768, 1)
    return {"sparse": sparse, "dense": dense, "extremes": extremes,
            "zeros": np.zeros((30, 64), np.int16)}


@pytest.mark.parametrize("case", ["sparse", "dense", "extremes", "zeros"])
def test_encode_coeffs_bytes_equal_and_round_trip(rng, case):
    coeffs = _coeff_cases(rng)[case]
    assert je.native_available()
    want = je.encode_coeffs(coeffs, 64)
    got = te.encode_coeffs(coeffs, 64)
    assert got == want and got[0] == te.BACKEND_NATIVE
    back = te.decode_coeffs(*got, coeffs.size, 64)
    np.testing.assert_array_equal(back.reshape(coeffs.shape), coeffs)
    np.testing.assert_array_equal(je.decode_coeffs(*got, coeffs.size, 64), back)


@pytest.mark.parametrize("case", ["modes", "vectors", "random", "empty"])
def test_encode_bytes_bytes_equal_and_round_trip(rng, case):
    data = {
        "modes": (rng.random((4, 6, 8)) < 0.7).astype(np.uint8),
        "vectors": (rng.integers(-8, 9, (4, 6, 8, 2)) + 128).astype(np.uint8),
        "random": rng.integers(0, 256, 5000).astype(np.uint8),
        "empty": np.zeros(0, np.uint8),
    }[case]
    want = je.encode_bytes(data)
    got = te.encode_bytes(data)
    assert got == want and got[0] == te.BACKEND_NATIVE
    np.testing.assert_array_equal(te.decode_bytes(*got, data.size), data.reshape(-1))


def test_zlib_sections_still_decode(rng):
    coeffs = rng.integers(-20, 21, (10, 64)).astype(np.int16)
    data = rng.integers(0, 256, 300).astype(np.uint8)
    np.testing.assert_array_equal(
        te.decode_coeffs(te.BACKEND_ZLIB, zlib.compress(coeffs.tobytes(), 6), coeffs.size, 64),
        coeffs.reshape(-1))
    np.testing.assert_array_equal(
        te.decode_bytes(te.BACKEND_ZLIB, zlib.compress(data.tobytes(), 6), data.size), data)


def test_encode_raises_when_the_library_cannot_be_built(monkeypatch, tmp_path, rng):
    """No silent zlib stream: with the source missing (and no library
    loaded) both encoders raise, and so does a decode of a native section."""
    monkeypatch.setattr(te, "_lib", None)
    monkeypatch.setattr(te, "_CSRC", tmp_path / "missing" / "rangecoder.cpp")
    assert not te.native_available()
    with pytest.raises(RuntimeError, match="range coder"):
        te.encode_coeffs(np.zeros((2, 64), np.int16), 64)
    with pytest.raises(RuntimeError, match="range coder"):
        te.encode_bytes(np.zeros(8, np.uint8))
    with pytest.raises(RuntimeError, match="range coder"):
        te.decode_bytes(te.BACKEND_NATIVE, b"\x00" * 8, 8)
    # a source that does not compile raises too, with the compiler's words
    bad = tmp_path / "rangecoder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(te, "_CSRC", bad)
    monkeypatch.setattr(te, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        te.encode_bytes(np.zeros(8, np.uint8))
