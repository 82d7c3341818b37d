"""ROI sidecar writers for the external encoders (port of
``elvis_tpu.codec.roi``). These are host files and their bytes are the
contract, so every step keeps the JAX package's dtype:

  * x265 qpfile: scores -> QP offsets ``clip(2s-1, -1, 1)`` in float32; the
    CTU size by block size and resolution (>=4320 -> 64, >=2160 -> 32, else
    16 at least); the block maps regridded to the CTU grid on the device
    (``area`` when cells grow, ``linear`` when they shrink); per-frame lines
    ``<idx> P -1 x,y,qp ...`` in raster order with 4-decimal offsets.
  * Kvazaar binary ROI: per frame int32 ``(w, h)`` then int8
    ``delta-QP[h][w]``; ``dqp = (1-imp)*2r - r`` in float64, clamped to +-14
    and to HEVC QP validity, truncated by ``astype(int8)``.
  * SVT-AV1 text ROI: fixed 64x64 superblocks, importance (float32, area
    regridded on the device when the grid differs) quantized to 8 AV1
    segments by truncation, ``dqp = r - level*2r//7``, clamped to AV1 QP
    validity; lines ``<frame> off1 off2 ...``.

The regrid's float32 sums run in PyTorch's order, not XLA's: a qpfile value
may differ from the JAX package's in its fourth decimal where the exact
value sits on a rounding boundary (ROADMAP.md §3).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.ops.resize import resize

__all__ = [
    "select_ctu_size",
    "qp_offsets_from_scores",
    "write_x265_qpfile",
    "write_kvazaar_roi",
    "write_svtav1_roi",
]

KVAZAAR_DELTA_LIMIT = 14
HEVC_QP_RANGE = (0, 51)
AV1_QP_RANGE = (0, 63)
AV1_SUPERBLOCK = 64
AV1_SEGMENTS = 8


def select_ctu_size(block_size: int, width: int, height: int) -> int:
    """The nearest legal CTU {16,32,64} to block_size, raised to the
    resolution's minimum."""
    valid = [16, 32, 64]
    largest = max(width, height)
    min_ctu = 16
    if largest >= 4320:
        min_ctu = 64
    elif largest >= 2160:
        min_ctu = 32

    nearest = min(valid, key=lambda s: abs(s - block_size))
    if nearest < block_size:
        larger = [s for s in valid if s >= block_size]
        ctu = larger[0] if larger else valid[-1]
    else:
        ctu = nearest
    if ctu < min_ctu:
        compliant = [s for s in valid if s >= min_ctu]
        ctu = compliant[0] if compliant else valid[-1]
    return ctu


def qp_offsets_from_scores(scores: np.ndarray) -> np.ndarray:
    """Removability [0,1] -> QP offset [-1,1] (float32)."""
    return np.clip(np.asarray(scores, dtype=np.float32) * 2.0 - 1.0, -1.0, 1.0)


def _resize_maps(maps: np.ndarray, rows: int, cols: int, method: str, device) -> np.ndarray:
    """``(..., By, Bx)`` float32 block maps -> ``(..., rows, cols)`` on
    ``device``, back on the host."""
    t = torch.as_tensor(np.ascontiguousarray(maps, dtype=np.float32),
                        device=resolve_device(device))
    return resize(t, (rows, cols), method=method, channels=False).cpu().numpy()


def _regrid(maps: np.ndarray, rows: int, cols: int, block_size: int, ctu: int,
            device="cuda") -> np.ndarray:
    """Per-frame block maps on the CTU grid: ``area`` when cells grow
    (cv2 INTER_AREA), ``linear`` when they shrink."""
    n, by, bx = maps.shape
    if (rows, cols) == (by, bx):
        return maps.astype(np.float32)
    return _resize_maps(maps, rows, cols, "area" if ctu >= block_size else "linear", device)


def write_x265_qpfile(path: str, removability_scores: np.ndarray, block_size: int,
                      width: int, height: int, device="cuda") -> int:
    """Write the qpfile; returns the CTU size used (the caller passes it to
    the encoder). The regrid runs on ``device``."""
    qp_maps = qp_offsets_from_scores(np.asarray(removability_scores))
    ctu = select_ctu_size(block_size, width, height)
    rows = math.ceil(height / ctu)
    cols = math.ceil(width / ctu)
    aligned = _regrid(qp_maps, rows, cols, block_size, ctu, device)

    with open(path, "w") as f:
        for idx in range(aligned.shape[0]):
            parts = [f"{idx} P -1"]
            frame = aligned[idx]
            parts.extend(f"{bx},{by},{frame[by, bx]:.4f}"
                         for by in range(rows) for bx in range(cols))
            f.write(" ".join(parts) + "\n")
    return ctu


def write_kvazaar_roi(path: str, importance_scores: Sequence[np.ndarray], base_qp: int,
                      qp_range: int = 15) -> None:
    lo, hi = HEVC_QP_RANGE
    with open(path, "wb") as f:
        for importance in importance_scores:
            imp = np.asarray(importance, dtype=np.float64)
            h, w = imp.shape
            f.write(np.array([w, h], dtype=np.int32).tobytes())
            dqp = (1.0 - imp) * 2 * qp_range - qp_range
            dqp = np.clip(dqp, -KVAZAAR_DELTA_LIMIT, KVAZAAR_DELTA_LIMIT)
            dqp = np.clip(dqp, lo - base_qp, hi - base_qp)
            f.write(dqp.astype(np.int8).tobytes())


def write_svtav1_roi(path: str, importance_scores: Sequence[np.ndarray], base_crf: int,
                     qp_range: int, width: int, height: int, device="cuda") -> None:
    """Write the ROI map file; a regrid to the superblock grid runs on
    ``device``."""
    lo, hi = AV1_QP_RANGE
    cols = (width + AV1_SUPERBLOCK - 1) // AV1_SUPERBLOCK
    rows = (height + AV1_SUPERBLOCK - 1) // AV1_SUPERBLOCK
    with open(path, "w") as f:
        for frame_idx, importance in enumerate(importance_scores):
            imp = np.asarray(importance, dtype=np.float32)
            if imp.shape != (rows, cols):
                imp = _resize_maps(imp, rows, cols, "area", device)
            levels = np.clip((imp * AV1_SEGMENTS).astype(np.int32), 0, AV1_SEGMENTS - 1)
            dqp = qp_range - (levels * 2 * qp_range // (AV1_SEGMENTS - 1))
            dqp = np.clip(dqp, lo - base_crf, hi - base_crf)
            offsets = dqp.flatten().astype(int)
            f.write(f"{frame_idx} " + " ".join(map(str, offsets)) + "\n")
