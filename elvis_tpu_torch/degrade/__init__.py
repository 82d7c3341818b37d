from elvis_tpu_torch.degrade.adaptive import (
    adaptive_blur,
    adaptive_downsample,
    adaptive_downsample_scale,
    blur_levels_from_scores,
    downsample_levels_from_scores,
)

__all__ = [
    "adaptive_blur",
    "adaptive_downsample",
    "adaptive_downsample_scale",
    "blur_levels_from_scores",
    "downsample_levels_from_scores",
]
