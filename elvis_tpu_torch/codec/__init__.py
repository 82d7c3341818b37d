"""Codec boundary (port of ``elvis_tpu.codec``): the built-in NVC codec, the
strength-map sidecars and the pipeline's codec adapter.

QUALITY_PRESETS: named tiers mapping to per-encoder parameters, with an
'nvc_qp' column for the built-in codec. The external encoder wrappers
(x265, kvazaar, SVT-AV1), their ROI files and the Y4M reader are not ported
yet.
"""

from elvis_tpu_torch.codec.nvc.codec import NvcCodec, decode as nvc_decode, encode as nvc_encode
from elvis_tpu_torch.codec.sidecar import (
    decode_strength_maps,
    encode_strength_maps,
    load_removal_masks_npz,
    load_strength_maps_npz,
    load_strength_maps_video,
    save_removal_masks_npz,
    save_strength_maps_npz,
    save_strength_maps_video,
)

QUALITY_PRESETS = {
    "lossless": {"kvazaar_qp": 2, "svtav1_crf": 1, "qp_range": 0, "nvc_qp": 4},
    "high": {"kvazaar_qp": 30, "svtav1_crf": 30, "qp_range": 10, "nvc_qp": 24},
    "medium": {"kvazaar_qp": 35, "svtav1_crf": 40, "qp_range": 12, "nvc_qp": 32},
    "low": {"kvazaar_qp": 38, "svtav1_crf": 50, "qp_range": 14, "nvc_qp": 38},
    "lowest": {"kvazaar_qp": 42, "svtav1_crf": 60, "qp_range": 15, "nvc_qp": 44},
}


def calculate_target_bitrate(
    width: int, height: int, framerate: float, quality_factor: float = 1.2
) -> int:
    """The bitrate model: W*H*fps*0.01*qf bps."""
    return int(width * height * framerate * 0.01 * quality_factor)


__all__ = [
    "NvcCodec",
    "QUALITY_PRESETS",
    "calculate_target_bitrate",
    "decode_strength_maps",
    "encode_strength_maps",
    "load_removal_masks_npz",
    "load_strength_maps_npz",
    "load_strength_maps_video",
    "nvc_decode",
    "nvc_encode",
    "save_removal_masks_npz",
    "save_strength_maps_npz",
    "save_strength_maps_video",
]
