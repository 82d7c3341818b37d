"""Codec dispatch (port of ``elvis_tpu.codec.dispatch``): one interface over
the pipeline's codecs, so the orchestrator stays codec-agnostic. Every codec
presents ``encode`` / ``encode_roi`` / ``decode`` on in-memory (N,H,W,3)
uint8 frames and bitstream bytes.

  * 'nvc': the built-in codec; frames never leave the process and per-block
    delta-QP is native to the quantizer.
  * 'x265', 'kvazaar', 'svtav1': the external encoder wrappers, not ported
    yet (ROADMAP.md §1, "ROI and external codecs").
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from elvis_tpu_torch.codec.nvc.codec import NvcCodec

__all__ = ["make_pipeline_codec", "PipelineCodec", "NvcPipelineCodec"]

_NOT_PORTED = ("x265", "kvazaar", "svtav1")


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


def make_pipeline_codec(
    codec: str, workdir: str, width: int, height: int,
    *, preset: str = "medium", pix_fmt: str = "yuv420p",
    quality: str = "medium", nvc_b_frames: bool = False,
    nvc_me_radius: int = 4, nvc_multi_ref: bool = False,
    nvc_deblock: bool = True, nvc_intra_pred: bool = True, device="cuda",
) -> PipelineCodec:
    """The pipeline's codec by name; ``workdir``, ``width``, ``height``,
    ``preset``, ``pix_fmt`` and ``quality`` are the external encoders'."""
    codecs: Dict[str, callable] = {
        "nvc": lambda: NvcPipelineCodec(b_frames=nvc_b_frames,
                                        me_radius=nvc_me_radius,
                                        multi_ref=nvc_multi_ref,
                                        deblock=nvc_deblock,
                                        intra_pred=nvc_intra_pred, device=device),
    }
    if codec in _NOT_PORTED:
        raise NotImplementedError(
            f"codec {codec!r}: not ported yet (the external encoder wrappers: "
            "ROADMAP.md §1, 'ROI and external codecs')")
    if codec not in codecs:
        raise ValueError(f"unknown codec {codec!r}; choose from "
                         f"{sorted([*codecs, *_NOT_PORTED])}")
    return codecs[codec]()
