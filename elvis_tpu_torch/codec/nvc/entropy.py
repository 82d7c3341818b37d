"""ctypes binding to the native range coder (port of
``elvis_tpu.codec.nvc.entropy``).

``csrc/rangecoder.cpp`` is the JAX package's range coder, byte for byte; it
is compiled with the host compiler at first use by the port's one native
builder (``elvis_tpu_torch.kernels._build``, library ``nvc_rc``) and bound
over its C interface: flat arrays in, bytes out.

Each section of a stream records the backend that wrote it. ``decode_*``
reads both backends, the zlib one too, because it is part of the stream
format. ``encode_*`` writes the native backend only and raises when the
library cannot be built or refuses the input: a zlib section has other bytes
and another bitrate, so the port never writes one silently.
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from typing import Optional

import numpy as np

__all__ = [
    "native_available",
    "encode_coeffs",
    "decode_coeffs",
    "encode_bytes",
    "decode_bytes",
    "BACKEND_NATIVE",
    "BACKEND_ZLIB",
]

BACKEND_NATIVE = 0
BACKEND_ZLIB = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The range coder library, built first when missing; raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    from elvis_tpu_torch.kernels import _build

    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = _build.load("nvc_rc")
        except OSError as exc:  # missing source or compiler, unloadable library
            raise RuntimeError(f"the native range coder cannot be built: {exc}") from exc
        u8, i16 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16)
        i64 = ctypes.c_longlong
        lib.nvc_rc_encode.restype = i64
        lib.nvc_rc_encode.argtypes = [i16, i64, ctypes.c_int, u8, i64]
        lib.nvc_rc_decode.restype = i64
        lib.nvc_rc_decode.argtypes = [u8, i64, i64, ctypes.c_int, i16]
        lib.nvc_rc_encode_bytes.restype = i64
        lib.nvc_rc_encode_bytes.argtypes = [u8, i64, u8, i64]
        lib.nvc_rc_decode_bytes.restype = i64
        lib.nvc_rc_decode_bytes.argtypes = [u8, i64, i64, u8]
        _lib = lib
    return _lib


def native_available() -> bool:
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i16(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def encode_coeffs(coeffs: np.ndarray, block_len: int) -> tuple[int, bytes]:
    """int16 array (flat, length % block_len == 0) -> (backend, payload)."""
    flat = np.ascontiguousarray(coeffs, dtype=np.int16).reshape(-1)
    assert flat.size % block_len == 0, (flat.size, block_len)
    lib = _load()
    cap = flat.size * 4 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.nvc_rc_encode(_i16(flat), flat.size, block_len, _u8(out), cap)
    if n < 0:
        raise RuntimeError(f"the range coder refused {flat.size} coefficients (rc {n})")
    return BACKEND_NATIVE, out[:n].tobytes()


def decode_coeffs(backend: int, payload: bytes, n: int, block_len: int) -> np.ndarray:
    if backend == BACKEND_ZLIB:
        return np.frombuffer(zlib.decompress(payload), dtype=np.int16)[:n].copy()
    lib = _load()
    out = np.empty(n, dtype=np.int16)
    buf = np.frombuffer(payload, dtype=np.uint8)
    got = lib.nvc_rc_decode(_u8(buf), buf.size, n, block_len, _i16(out))
    assert got == n
    return out


def encode_bytes(data: np.ndarray) -> tuple[int, bytes]:
    flat = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    lib = _load()
    cap = flat.size * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.nvc_rc_encode_bytes(_u8(flat), flat.size, _u8(out), cap)
    if n < 0:
        raise RuntimeError(f"the range coder refused {flat.size} bytes (rc {n})")
    return BACKEND_NATIVE, out[:n].tobytes()


def decode_bytes(backend: int, payload: bytes, n: int) -> np.ndarray:
    if backend == BACKEND_ZLIB:
        return np.frombuffer(zlib.decompress(payload), dtype=np.uint8)[:n].copy()
    lib = _load()
    out = np.empty(n, dtype=np.uint8)
    buf = np.frombuffer(payload, dtype=np.uint8)
    got = lib.nvc_rc_decode_bytes(_u8(buf), buf.size, n, _u8(out))
    assert got == n
    return out
