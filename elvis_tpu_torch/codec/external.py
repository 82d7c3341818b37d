"""Wrappers for the external encoders: ffmpeg/libx265, kvazaar, SVT-AV1
(port of ``elvis_tpu.codec.external``).

Every wrapper runs its binary as a subprocess on host files:
  * ``is_available`` probes for the binary;
  * a missing binary raises ``CodecUnavailable``;
  * ``ELVIS_TPU_FAKE_CODECS=<dir>`` is the JAX package's test shim, byte for
    byte: each argv is appended to ``<dir>/argv.jsonl`` as one JSON line and
    each output file is written as ``b"FAKE" + basename``, so the command
    recipes stay testable where no encoder is installed.

The recipes are the JAX package's: two-pass libx265 with minrate/maxrate
0.9-1.1x and GOP = framerate (the qpfile on pass 2 only); kvazaar -> raw
HEVC -> mkvmerge -> ffmpeg copy-mux (kvazaar's exit code is not checked, its
output file is); SvtAv1EncApp -> IVF -> ffmpeg copy-mux.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from elvis_tpu_torch.codec.roi import write_kvazaar_roi, write_svtav1_roi
from elvis_tpu_torch.codec.y4m import write_y4m

__all__ = [
    "CodecUnavailable",
    "is_available",
    "encode_video_x265",
    "decode_video_ffmpeg",
    "encode_kvazaar",
    "encode_svtav1",
]


class CodecUnavailable(RuntimeError):
    pass


def _fake_dir() -> Optional[Path]:
    d = os.environ.get("ELVIS_TPU_FAKE_CODECS")
    return Path(d) if d else None


def is_available(binary: str) -> bool:
    if _fake_dir() is not None:
        return True
    return shutil.which(binary) is not None


def _record(fake: Path, argv: List[str]) -> None:
    fake.mkdir(parents=True, exist_ok=True)
    with open(fake / "argv.jsonl", "a") as f:
        f.write(json.dumps(argv) + "\n")


def _run(cmd: List[str], check: bool = True, output_file: Optional[str] = None):
    fake = _fake_dir()
    if fake is not None:
        _record(fake, cmd)
        if output_file is not None:
            Path(output_file).parent.mkdir(parents=True, exist_ok=True)
            with open(output_file, "wb") as f:
                f.write(b"FAKE" + os.path.basename(output_file).encode())
        return subprocess.CompletedProcess(cmd, 0, "", "")
    if not is_available(cmd[0]):
        raise CodecUnavailable(
            f"{cmd[0]!r} not found; install it or use the built-in 'nvc' codec")
    return subprocess.run(cmd, check=check, capture_output=True, text=True)


def encode_video_x265(input_frames_dir: str, output_video: str, framerate: float,
                      width: int, height: int, target_bitrate: Optional[int] = None,
                      preset: str = "medium", pix_fmt: str = "yuv420p",
                      **extra_params) -> None:
    """Two-pass libx265 from a ``%05d.png`` directory. ``extra_params``
    become x265-params (``ctu=...``, ``qpfile=...``); the qpfile reaches
    pass 2 only. Without a target bitrate: lossless at preset 'fast'."""
    temp_dir = os.path.dirname(output_video) or "."
    os.makedirs(temp_dir, exist_ok=True)
    passlog = os.path.join(temp_dir, f"ffmpeg_2pass_log_{os.path.basename(output_video)}")
    null_device = "/dev/null"

    extra_params = {k: v for k, v in extra_params.items() if v is not None}
    pass1_extra = {k: v for k, v in extra_params.items() if k != "qpfile"}

    def x265p(base: str, params: Dict) -> str:
        return base + "".join(f":{k}={v}" for k, v in params.items())

    base_cmd = [
        "ffmpeg", "-hide_banner", "-loglevel", "error",
        "-framerate", str(framerate),
        "-i", f"{input_frames_dir}/%05d.png",
        "-vf", f"scale={width}:{height}:flags=lanczos,format={pix_fmt}",
    ]
    try:
        if target_bitrate is None:
            preset = "fast"
            p1 = x265p(f"lossless=1:pass=1:stats={passlog}", pass1_extra)
            _run(base_cmd + ["-c:v", "libx265", "-preset", preset,
                             "-x265-params", p1, "-f", "mp4", "-y", null_device])
            p2 = x265p(f"lossless=1:pass=2:stats={passlog}", extra_params)
            _run(base_cmd + ["-c:v", "libx265", "-preset", preset,
                             "-x265-params", p2, "-y", output_video],
                 output_file=output_video)
        else:
            rate_args = [
                "-b:v", str(target_bitrate),
                "-minrate", str(int(target_bitrate * 0.9)),
                "-maxrate", str(int(target_bitrate * 1.1)),
                "-bufsize", str(target_bitrate),
                "-preset", preset,
                "-g", str(framerate),
            ]
            p1 = x265p(f"pass=1:stats={passlog}", pass1_extra)
            _run(base_cmd + ["-c:v", "libx265"] + rate_args
                 + ["-x265-params", p1, "-f", "mp4", "-y", null_device])
            p2 = x265p(f"pass=2:stats={passlog}", extra_params)
            _run(base_cmd + ["-c:v", "libx265"] + rate_args
                 + ["-x265-params", p2, "-y", output_video],
                 output_file=output_video)
    finally:
        for f in glob.glob(passlog + "*"):
            try:
                os.remove(f)
            except OSError:
                pass


def decode_video_ffmpeg(video_path: str, width: int, height: int) -> np.ndarray:
    """Decode to an ``(N,H,W,3)`` uint8 RGB host array through a rawvideo
    pipe. Under the shim: the argv line ``["ffmpeg-decode", path]`` and one
    black frame."""
    fake = _fake_dir()
    if fake is not None:
        _record(fake, ["ffmpeg-decode", video_path])
        return np.zeros((1, height, width, 3), dtype=np.uint8)
    if not is_available("ffmpeg"):
        raise CodecUnavailable("ffmpeg not found")
    cmd = [
        "ffmpeg", "-hide_banner", "-loglevel", "warning",
        "-i", video_path,
        "-vf", f"scale={width}:{height}",
        "-f", "image2pipe", "-pix_fmt", "rgb24", "-vcodec", "rawvideo", "-",
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    frame_size = width * height * 3
    frames = []
    while True:
        raw = proc.stdout.read(frame_size)
        if len(raw) < frame_size:
            break
        frames.append(np.frombuffer(raw, np.uint8).reshape(height, width, 3))
    proc.stdout.close()
    proc.wait()
    return np.stack(frames, axis=0) if frames else np.zeros((0, height, width, 3), np.uint8)


def _temp_y4m(frames, framerate: float) -> str:
    """A temporary y4m of the frames (only its name under the shim)."""
    with tempfile.NamedTemporaryFile(suffix=".y4m", delete=False) as tmp:
        path = tmp.name
    if _fake_dir() is None:
        write_y4m(frames, path, framerate)
    return path


def _unlink(*paths) -> None:
    for p in paths:
        if p and os.path.exists(p):
            os.unlink(p)


def encode_kvazaar(frames: Sequence[np.ndarray], output_path: str, framerate: float,
                   qp: int = 48, qp_range: int = 15,
                   importance_scores: Optional[Sequence[np.ndarray]] = None,
                   gop: Optional[int] = None) -> None:
    """kvazaar -> mkvmerge -> ffmpeg mux. ``gop`` sets the intra period
    (``--period``); ``importance_scores`` write a binary ROI file."""
    output_path = str(output_path)
    y4m_path = _temp_y4m(frames, framerate)
    hevc_path = output_path.replace(".mp4", ".hevc")
    cmd = ["kvazaar", "-i", y4m_path, "-q", str(qp), "-o", hevc_path, "--preset", "medium"]
    if gop:
        cmd.extend(["--period", str(int(gop))])
    roi_path = None
    if importance_scores is not None:
        roi_path = output_path.replace(".mp4", "_roi.bin")
        write_kvazaar_roi(roi_path, importance_scores, base_qp=qp, qp_range=qp_range)
        cmd.extend(["--roi", roi_path])
    # kvazaar may crash on exit after writing a good stream: check the
    # output file, not the exit code
    _run(cmd, check=False, output_file=hevc_path)
    if not os.path.exists(hevc_path) or os.path.getsize(hevc_path) == 0:
        raise RuntimeError(f"Kvazaar failed to produce output: {hevc_path}")
    mkv_path = hevc_path.replace(".hevc", ".mkv")
    _run(["mkvmerge", "-o", mkv_path,
          "--default-duration", f"0:{int(framerate)}fps", hevc_path],
         output_file=mkv_path)
    _run(["ffmpeg", "-hide_banner", "-loglevel", "warning", "-y",
          "-i", mkv_path, "-c:v", "copy", "-movflags", "+faststart", output_path],
         output_file=output_path)
    _unlink(y4m_path, hevc_path, mkv_path, roi_path)


def encode_svtav1(frames: Sequence[np.ndarray], output_path: str, framerate: float,
                  crf: int = 35, qp_range: int = 15,
                  importance_scores: Optional[Sequence[np.ndarray]] = None,
                  gop: Optional[int] = None, device="cuda") -> None:
    """SvtAv1EncApp -> IVF -> ffmpeg mux. ``gop`` sets the keyframe interval
    (``--keyint``); ``importance_scores`` write a text ROI map, regridded to
    the superblock grid on ``device``."""
    output_path = str(output_path)
    height, width = np.asarray(frames[0]).shape[:2]
    y4m_path = _temp_y4m(frames, framerate)
    ivf_path = output_path.replace(".mp4", ".ivf")
    cmd = ["SvtAv1EncApp", "-i", y4m_path, "-b", ivf_path, "--preset", "8", "--crf", str(crf)]
    if gop:
        cmd.extend(["--keyint", str(int(gop))])
    roi_path = None
    if importance_scores is not None:
        roi_path = output_path.replace(".mp4", "_roi.txt")
        write_svtav1_roi(roi_path, importance_scores, base_crf=crf, qp_range=qp_range,
                         width=width, height=height, device=device)
        cmd.extend(["--roi-map-file", roi_path])
    _run(cmd, output_file=ivf_path)
    if not os.path.exists(ivf_path) or os.path.getsize(ivf_path) == 0:
        raise RuntimeError("SVT-AV1 failed to produce output")
    _run(["ffmpeg", "-hide_banner", "-loglevel", "warning", "-y",
          "-i", ivf_path, "-c:v", "copy", "-movflags", "+faststart", output_path],
         output_file=output_path)
    _unlink(y4m_path, ivf_path, roi_path)
