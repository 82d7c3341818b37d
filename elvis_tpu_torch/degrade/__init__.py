from elvis_tpu_torch.degrade.adaptive import (
    adaptive_blur,
    adaptive_downsample,
    adaptive_downsample_scale,
    blur_levels_from_scores,
    downsample_levels_from_scores,
)
from elvis_tpu_torch.degrade.dct_dampen import dampen_levels_from_scores, dct_dampen
from elvis_tpu_torch.degrade.removal import apply_selective_removal, stretch_frames

__all__ = [
    "adaptive_blur",
    "adaptive_downsample",
    "adaptive_downsample_scale",
    "apply_selective_removal",
    "blur_levels_from_scores",
    "dampen_levels_from_scores",
    "dct_dampen",
    "downsample_levels_from_scores",
    "stretch_frames",
]
