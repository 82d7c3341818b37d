"""VMAF host wrapper (port of ``elvis_tpu.metrics.vmaf``): the ``vmaf``
binary, when one is on PATH, is the authoritative perceptual score.

Both clips go to raw I420 files (the port's own colour transform), the
binary runs with ``--json``, and the pooled mean / min / harmonic mean are
parsed. Without the binary every score is NaN and the evaluation schema
carries the NaNs.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

import numpy as np

__all__ = ["vmaf_available", "compute_vmaf"]

_NAN = {"mean": float("nan"), "min": float("nan"), "harmonic_mean": float("nan")}


def _vmaf_binary() -> Optional[str]:
    """The ``vmaf`` binary on PATH, if any."""
    return shutil.which("vmaf")


def vmaf_available() -> bool:
    return _vmaf_binary() is not None


def _write_yuv(frames: np.ndarray, path: str) -> None:
    import torch

    from elvis_tpu_torch.ops.color import rgb_to_yuv420

    y, cb, cr = rgb_to_yuv420(torch.from_numpy(np.ascontiguousarray(frames, np.float32)))
    y, cb, cr = (np.clip(np.round(p.numpy()), 0, 255).astype(np.uint8) for p in (y, cb, cr))
    with open(path, "wb") as f:
        for i in range(frames.shape[0]):
            f.write(y[i].tobytes())
            f.write(cb[i].tobytes())
            f.write(cr[i].tobytes())


def compute_vmaf(
    ref_frames: np.ndarray, dec_frames: np.ndarray, framerate: float = 30.0
) -> Dict[str, float]:
    """-> {'mean', 'min', 'harmonic_mean'} (NaN when the binary is missing
    or fails). Frames: (N,H,W,3) host arrays; an odd side is cropped by one
    pixel for the I420 files."""
    binary = _vmaf_binary()
    if binary is None:
        return dict(_NAN)
    # I420 needs even sides: a crop of odd size loses its last row/column
    h, w = ref_frames.shape[1] // 2 * 2, ref_frames.shape[2] // 2 * 2
    ref_frames, dec_frames = ref_frames[:, :h, :w], dec_frames[:, :h, :w]
    with tempfile.TemporaryDirectory() as td:
        ref_yuv = os.path.join(td, "ref.yuv")
        dec_yuv = os.path.join(td, "dec.yuv")
        out_json = os.path.join(td, "vmaf.json")
        _write_yuv(np.asarray(ref_frames), ref_yuv)
        _write_yuv(np.asarray(dec_frames), dec_yuv)
        cmd = [
            binary,
            "--reference", ref_yuv,
            "--distorted", dec_yuv,
            "--width", str(w), "--height", str(h),
            "--pixel_format", "420", "--bitdepth", "8",
            "--json", "--output", out_json,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0 or not os.path.exists(out_json):
            return dict(_NAN)
        with open(out_json) as f:
            data = json.load(f)
    pooled = data.get("pooled_metrics", {}).get("vmaf", {})
    return {
        "mean": float(pooled.get("mean", float("nan"))),
        "min": float(pooled.get("min", float("nan"))),
        "harmonic_mean": float(pooled.get("harmonic_mean", float("nan"))),
    }
