"""Codec dispatch (port of ``elvis_tpu.codec.dispatch``): one interface over
the pipeline's codecs, so the orchestrator stays codec-agnostic. Every codec
presents ``encode`` / ``encode_roi`` / ``decode`` on in-memory (N,H,W,3)
uint8 frames (a numpy array or a tensor) and bitstream bytes; ``decode``
returns a tensor on the codec's device.

  * 'nvc': the built-in codec; frames never leave the process and per-block
    delta-QP is native to the quantizer.
  * 'x265': a PNG staging dir -> two-pass libx265; ROI through a qpfile
    computed from the REMOVABILITY scores.
  * 'kvazaar': Y4M -> kvazaar -q QP [--roi roi.bin] -> mkvmerge mux; ROI from
    the IMPORTANCE scores.
  * 'svtav1': Y4M -> SvtAv1EncApp --crf [--roi-map-file] -> mux.

Where no encoder is installed the external ones run under the
``ELVIS_TPU_FAKE_CODECS`` shim (``codec.external``): the argv chains are
recorded, and the adapter returns a lossless stash of its input frames as
the "stream" (``ELVISFAKE1`` + an npz, the JAX package's format, so a stash
written by one package decodes in the other). ``decode`` of a stash returns
the true content, so a shim run drives every restore and metric; its bits
are the stash's size, not an encoder's.
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from elvis_tpu_torch.codec import QUALITY_PRESETS
from elvis_tpu_torch.codec.external import (
    _fake_dir,
    decode_video_ffmpeg,
    encode_kvazaar,
    encode_svtav1,
    encode_video_x265,
)
from elvis_tpu_torch.codec.nvc.codec import NvcCodec, encode as nvc_encode
from elvis_tpu_torch.codec.roi import write_x265_qpfile
from elvis_tpu_torch.device import resolve_device

__all__ = ["make_pipeline_codec", "PipelineCodec", "NvcPipelineCodec", "X265PipelineCodec",
           "KvazaarPipelineCodec", "SvtAv1PipelineCodec"]

_FAKE_MAGIC = b"ELVISFAKE1"


def _fake_pack(frames: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, frames=np.asarray(frames, dtype=np.uint8))
    return _FAKE_MAGIC + buf.getvalue()


def _fake_unpack(stream: bytes) -> Optional[np.ndarray]:
    if not stream.startswith(_FAKE_MAGIC):
        return None
    return np.load(io.BytesIO(stream[len(_FAKE_MAGIC):]))["frames"]


def _host(frames) -> np.ndarray:
    """Frames as a host numpy array (a tensor leaves its device)."""
    if isinstance(frames, torch.Tensor):
        return frames.detach().cpu().numpy()
    return np.asarray(frames)


class PipelineCodec:
    """Common adapter surface. ``encode*`` take frames as a numpy array or a
    tensor and return bitstream bytes; ``decode`` returns (N,H,W,3) uint8
    RGB as a tensor on the codec's device."""

    name = "abstract"

    def encode(self, frames, *, target_bitrate: int, framerate: float, gop: int) -> bytes:
        raise NotImplementedError

    def encode_roi(self, frames, *, removability: np.ndarray, importance: np.ndarray,
                   block_size: int, roi_qp_range: int, target_bitrate: int,
                   framerate: float, gop: int) -> bytes:
        raise NotImplementedError

    def decode(self, stream: bytes) -> torch.Tensor:
        raise NotImplementedError


class NvcPipelineCodec(PipelineCodec):
    name = "nvc"

    def __init__(self, *, b_frames: bool = False, me_radius: int = 4,
                 multi_ref: bool = False, deblock: bool = True,
                 intra_pred: bool = True, device="cuda"):
        self._codec = NvcCodec(device)
        self._kw = dict(b_frames=b_frames, me_radius=me_radius,
                        multi_ref=multi_ref, deblock=deblock,
                        intra_pred=intra_pred)

    def encode(self, frames, *, target_bitrate, framerate, gop):
        return self._codec.encode(
            frames, target_bitrate=target_bitrate, framerate=framerate, gop=gop, **self._kw,
        )

    def encode_roi(self, frames, *, removability, importance, block_size,
                   roi_qp_range, target_bitrate, framerate, gop):
        # importance [0,1] -> delta-QP via the kvazaar ROI formula
        # (dqp = (1-imp)*2r - r; imp=1 foreground -> -r, better quality),
        # recentred to zero mean per frame so the map is a pure bit
        # *redistribution* under two-pass rate control.
        importance = np.asarray(importance)
        dqp_f = (1.0 - importance) * 2.0 * roi_qp_range - roi_qp_range
        dqp_f = dqp_f - dqp_f.mean(axis=(1, 2), keepdims=True)
        dqp = np.clip(np.round(dqp_f), -14, 14).astype(np.int8)
        return self._codec.encode(
            frames, target_bitrate=target_bitrate, framerate=framerate,
            roi_delta_qp=dqp, gop=gop, **self._kw,
        )

    def decode(self, stream):
        frames, _ = self._codec.decode(stream)
        return frames


class _ExternalBase(PipelineCodec):
    def __init__(self, workdir: str, width: int, height: int, device="cuda"):
        self.workdir = workdir
        self.width = width
        self.height = height
        self.device = resolve_device(device)
        self._counter = 0
        os.makedirs(workdir, exist_ok=True)

    def _next_path(self, suffix: str) -> str:
        self._counter += 1
        return os.path.join(self.workdir, f"{self.name}_{self._counter:03d}{suffix}")

    def _read_back(self, path: str, frames: np.ndarray) -> bytes:
        if _fake_dir() is not None:
            # lossless stash: decode returns the true content, so a shim run
            # drives the whole restoration path
            return _fake_pack(frames)
        with open(path, "rb") as f:
            return f.read()

    def decode(self, stream: bytes) -> torch.Tensor:
        frames = _fake_unpack(stream)
        if frames is None:
            with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as tmp:
                tmp.write(stream)
                path = tmp.name
            try:
                frames = decode_video_ffmpeg(path, self.width, self.height)
            finally:
                os.unlink(path)
        return torch.as_tensor(frames, device=self.device)


class X265PipelineCodec(_ExternalBase):
    """Two-pass libx265 from a PNG staging dir; ROI through a qpfile
    (removability -> QP offsets on the CTU grid, ``ctu=...:qpfile=...`` on
    pass 2)."""

    name = "x265"

    def __init__(self, workdir, width, height, preset="medium", pix_fmt="yuv420p",
                 device="cuda"):
        super().__init__(workdir, width, height, device)
        self.preset = preset
        self.pix_fmt = pix_fmt

    def _stage_frames(self, frames: np.ndarray) -> str:
        from elvis_tpu_torch.pipeline.io import save_frames_png

        d = self._next_path("_frames")
        if _fake_dir() is None:
            save_frames_png(frames, d)
        return d

    def encode(self, frames, *, target_bitrate, framerate, gop):
        frames = _host(frames)
        out = self._next_path(".mp4")
        encode_video_x265(
            self._stage_frames(frames), out, framerate, self.width, self.height,
            target_bitrate=target_bitrate, preset=self.preset, pix_fmt=self.pix_fmt,
        )
        return self._read_back(out, frames)

    def encode_roi(self, frames, *, removability, importance, block_size,
                   roi_qp_range, target_bitrate, framerate, gop):
        frames = _host(frames)
        qpfile = self._next_path(".qpfile")
        ctu = write_x265_qpfile(qpfile, np.asarray(removability), block_size, self.width,
                                self.height, device=self.device)
        out = self._next_path(".mp4")
        encode_video_x265(
            self._stage_frames(frames), out, framerate, self.width, self.height,
            target_bitrate=target_bitrate, preset=self.preset, pix_fmt=self.pix_fmt,
            ctu=ctu, qpfile=qpfile,
        )
        return self._read_back(out, frames)


class _RateModel:
    """target_bitrate -> HEVC QP (or AV1 CRF) for the encoders that take a QP:
    a probe encode of the clip's first ``PROBE_FRAMES`` frames with the
    port's NVC codec at QP 32 on ``device``, mapped through the law of ~6 QP
    per doubling of bits, as in the JAX package. Cached on (shape, the exact
    int64 sum of every other probe frame, target)."""

    PROBE_QP = 32
    PROBE_FRAMES = 8

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cache: Dict = {}

    def hevc_qp(self, frames, target_bitrate: float, framerate: float) -> int:
        frames = torch.as_tensor(frames, device=self.device)
        n = min(self.PROBE_FRAMES, frames.shape[0])
        key = (tuple(frames.shape), int(frames[:n:2].to(torch.int64).sum()),
               int(target_bitrate))
        if key not in self._cache:
            bits = len(nvc_encode(frames[:n], qp=self.PROBE_QP, framerate=framerate,
                                  device=self.device)) * 8
            target_bits = max(target_bitrate * n / framerate, 1.0)
            self._cache[key] = int(
                np.clip(round(self.PROBE_QP + 6 * np.log2(bits / target_bits)), 0, 51))
        return self._cache[key]

    def av1_crf(self, frames, target_bitrate: float, framerate: float) -> int:
        # AV1's CRF scale is 0-63 over the same perceptual range as HEVC's
        # 0-51 QP: rescale linearly
        qp = self.hevc_qp(frames, target_bitrate, framerate)
        return int(np.clip(round(qp * 63 / 51), 1, 63))


class KvazaarPipelineCodec(_ExternalBase):
    """kvazaar -q QP [--roi roi.bin] -> mkvmerge -> mp4. The QP comes from
    the rate model when a target_bitrate is given, else from the named
    quality preset."""

    name = "kvazaar"

    def __init__(self, workdir, width, height, quality: str = "medium", device="cuda"):
        super().__init__(workdir, width, height, device)
        preset = QUALITY_PRESETS[quality]
        self.qp = preset["kvazaar_qp"]
        self.qp_range = preset["qp_range"]
        self._rate = _RateModel(self.device)

    def _pick_qp(self, frames, target_bitrate, framerate) -> int:
        if target_bitrate:
            return self._rate.hevc_qp(frames, target_bitrate, framerate)
        return self.qp

    def encode(self, frames, *, target_bitrate, framerate, gop):
        out = self._next_path(".mp4")
        qp = self._pick_qp(frames, target_bitrate, framerate)
        frames = _host(frames)
        encode_kvazaar(frames, out, framerate, qp=qp, gop=gop)
        return self._read_back(out, frames)

    def encode_roi(self, frames, *, removability, importance, block_size,
                   roi_qp_range, target_bitrate, framerate, gop):
        out = self._next_path(".mp4")
        qp = self._pick_qp(frames, target_bitrate, framerate)
        frames = _host(frames)
        encode_kvazaar(frames, out, framerate, qp=qp, qp_range=self.qp_range,
                       importance_scores=np.asarray(importance), gop=gop)
        return self._read_back(out, frames)


class SvtAv1PipelineCodec(_ExternalBase):
    """SvtAv1EncApp --crf [--roi-map-file] -> IVF -> mp4. The CRF comes from
    the rate model when a target_bitrate is given, else from the named
    quality preset."""

    name = "svtav1"

    def __init__(self, workdir, width, height, quality: str = "medium", device="cuda"):
        super().__init__(workdir, width, height, device)
        preset = QUALITY_PRESETS[quality]
        self.crf = preset["svtav1_crf"]
        self.qp_range = preset["qp_range"]
        self._rate = _RateModel(self.device)

    def _pick_crf(self, frames, target_bitrate, framerate) -> int:
        if target_bitrate:
            return self._rate.av1_crf(frames, target_bitrate, framerate)
        return self.crf

    def encode(self, frames, *, target_bitrate, framerate, gop):
        out = self._next_path(".mp4")
        crf = self._pick_crf(frames, target_bitrate, framerate)
        frames = _host(frames)
        encode_svtav1(frames, out, framerate, crf=crf, gop=gop, device=self.device)
        return self._read_back(out, frames)

    def encode_roi(self, frames, *, removability, importance, block_size,
                   roi_qp_range, target_bitrate, framerate, gop):
        out = self._next_path(".mp4")
        crf = self._pick_crf(frames, target_bitrate, framerate)
        frames = _host(frames)
        encode_svtav1(frames, out, framerate, crf=crf, qp_range=self.qp_range,
                      importance_scores=np.asarray(importance), gop=gop, device=self.device)
        return self._read_back(out, frames)


def make_pipeline_codec(
    codec: str, workdir: str, width: int, height: int,
    *, preset: str = "medium", pix_fmt: str = "yuv420p",
    quality: str = "medium", nvc_b_frames: bool = False,
    nvc_me_radius: int = 4, nvc_multi_ref: bool = False,
    nvc_deblock: bool = True, nvc_intra_pred: bool = True, device="cuda",
) -> PipelineCodec:
    """The pipeline's codec by name; ``workdir``, ``width``, ``height``,
    ``preset``, ``pix_fmt`` and ``quality`` are the external encoders'.
    ``device`` is where NVC (and the external codecs' rate probe and ROI
    regrid) run and where ``decode`` puts its frames."""
    codecs: Dict[str, callable] = {
        "nvc": lambda: NvcPipelineCodec(b_frames=nvc_b_frames,
                                        me_radius=nvc_me_radius,
                                        multi_ref=nvc_multi_ref,
                                        deblock=nvc_deblock,
                                        intra_pred=nvc_intra_pred, device=device),
        "x265": lambda: X265PipelineCodec(workdir, width, height, preset, pix_fmt, device),
        "kvazaar": lambda: KvazaarPipelineCodec(workdir, width, height, quality, device),
        "svtav1": lambda: SvtAv1PipelineCodec(workdir, width, height, quality, device),
    }
    if codec not in codecs:
        raise ValueError(f"unknown codec {codec!r}; choose from {sorted(codecs)}")
    return codecs[codec]()
