"""Strength-map sidecars: the compressed per-block degradation metadata
(port of ``elvis_tpu.codec.sidecar``).

Two encodings of the (N, By, Bx) uint8 strength maps that accompany a
degraded bitstream:
  * npz: ``np.savez_compressed``;
  * video: normalize to 0-255 grayscale and encode as a tiny video with the
    built-in codec (lossy; the decode range rides along in the file).
Plus the in-memory lossless form (the range coder on the raw map) and the
ELVIS v1 removal-mask sidecar (packbits npz).

The maps are host arrays in and out. Only the video form runs the codec's
device half, on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from elvis_tpu_torch.codec.nvc import entropy

__all__ = [
    "save_strength_maps_npz",
    "save_strength_maps_video",
    "load_strength_maps_video",
    "load_strength_maps_npz",
    "encode_strength_maps",
    "decode_strength_maps",
    "encode_strength_maps_video",
    "decode_strength_maps_video",
    "save_removal_masks_npz",
    "load_removal_masks_npz",
]


def save_strength_maps_npz(maps: np.ndarray, path: str) -> int:
    maps = np.asarray(maps)
    if maps.dtype != np.uint8:
        maps = maps.astype(np.uint8)
    np.savez_compressed(path, strength_maps=maps)
    return os.path.getsize(path)


def load_strength_maps_npz(path: str) -> np.ndarray:
    return np.load(path)["strength_maps"]


_MAGIC = b"NVSM"


def encode_strength_maps(maps: np.ndarray) -> bytes:
    """Compressed in-memory sidecar (context-coded, lossless)."""
    maps = np.asarray(maps).astype(np.uint8)
    n, by, bx = maps.shape
    backend, payload = entropy.encode_bytes(maps)
    return _MAGIC + struct.pack("<HHHB", n, by, bx, backend) + payload


def decode_strength_maps(blob: bytes) -> np.ndarray:
    assert blob[:4] == _MAGIC
    n, by, bx, backend = struct.unpack_from("<HHHB", blob, 4)
    payload = blob[4 + struct.calcsize("<HHHB"):]
    return entropy.decode_bytes(backend, payload, n * by * bx).reshape(n, by, bx)


def _as_gray_rgb(maps: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Min-max normalize maps to 0-255 and repeat to three channels."""
    maps = np.asarray(maps, dtype=np.float32)
    lo, hi = float(maps.min()), float(maps.max())
    norm = (maps - lo) / (hi - lo + 1e-12) * 255.0
    return np.repeat(norm[..., None], 3, axis=-1).astype(np.uint8), lo, hi


def encode_strength_maps_video(
    maps: np.ndarray, *, framerate: float = 30.0, qp: int = 30, device="cuda"
) -> Tuple[bytes, float, float]:
    """Video-encoded sidecar: the block-resolution map as a grayscale frame
    of the built-in codec. Returns (stream, min_val, max_val); decode needs
    the range."""
    from elvis_tpu_torch.codec.nvc.codec import encode as nvc_encode

    rgb, lo, hi = _as_gray_rgb(maps)
    return nvc_encode(rgb, qp=qp, framerate=framerate, device=device), lo, hi


def decode_strength_maps_video(
    stream: bytes, min_val: float, max_val: float, device="cuda"
) -> np.ndarray:
    """Inverse: decode, rescale to [min, max], round to integer levels."""
    from elvis_tpu_torch.codec.nvc.codec import decode as nvc_decode

    frames = nvc_decode(stream, device=device)[0].cpu().numpy()
    gray = frames.astype(np.float32).mean(axis=-1)
    vals = gray / 255.0 * (max_val - min_val) + min_val
    return np.round(vals).astype(np.uint8)


_VMAGIC = b"NVSV"


def save_strength_maps_video(
    maps: np.ndarray, path: str, *, framerate: float = 30.0,
    target_bitrate: Optional[float] = None, qp: int = 30, device="cuda",
) -> int:
    """The VIDEO strength-map sidecar as a file: a gray video at about
    ``target_bitrate`` (through the codec's rate model) or at ``qp``, the
    decode range in-band. Returns the file size."""
    if target_bitrate is not None:
        from elvis_tpu_torch.codec.nvc.codec import NvcCodec

        rgb, lo, hi = _as_gray_rgb(maps)
        stream = NvcCodec(device).encode(rgb, target_bitrate=target_bitrate,
                                         framerate=framerate)
    else:
        stream, lo, hi = encode_strength_maps_video(maps, framerate=framerate, qp=qp,
                                                    device=device)
    with open(path, "wb") as f:
        f.write(_VMAGIC + struct.pack("<ff", lo, hi) + stream)
    return os.path.getsize(path)


def load_strength_maps_video(path: str, device="cuda") -> np.ndarray:
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == _VMAGIC
    lo, hi = struct.unpack_from("<ff", blob, 4)
    return decode_strength_maps_video(blob[4 + struct.calcsize("<ff"):], lo, hi, device=device)


def save_removal_masks_npz(masks: np.ndarray, path: str,
                           motion_gmv: "np.ndarray | None" = None,
                           motion_dev: "np.ndarray | None" = None) -> int:
    """ELVIS v1 removal masks, bit-packed.

    ``motion_gmv``/``motion_dev`` (a motion hint) ride the same sidecar:
    per-pair global int16 vectors + the coarse int8 deviation field. The
    sidecar's on-disk size is what bitrate accounting counts, so the hint's
    cost is charged to the ELVIS rows."""
    masks = np.asarray(masks).astype(bool)
    packed = np.packbits(masks, axis=None)
    extra = {}
    if motion_gmv is not None:
        extra["motion_gmv"] = np.asarray(motion_gmv, np.int16)
    if motion_dev is not None:
        extra["motion_dev"] = np.asarray(motion_dev, np.int8)
    np.savez_compressed(path, masks=packed, shape=np.asarray(masks.shape), **extra)
    return os.path.getsize(path)


def load_removal_masks_npz(path: str, with_motion: bool = False):
    data = np.load(path)
    shape = tuple(int(s) for s in data["shape"])
    total = int(np.prod(shape))
    masks = np.unpackbits(data["masks"], count=total).reshape(shape).astype(bool)
    if not with_motion:
        return masks
    gmv = data["motion_gmv"] if "motion_gmv" in data else None
    dev = data["motion_dev"] if "motion_dev" in data else None
    return masks, gmv, dev
