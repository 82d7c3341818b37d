from elvis_tpu_torch.scoring.complexity import spatial_temporal_complexity
from elvis_tpu_torch.scoring.fusion import importance_scores, removability_scores
from elvis_tpu_torch.scoring.saliency import (
    center_prior_saliency,
    get_saliency_fn,
    motion_contrast_saliency,
    register_saliency,
    saliency_to_block_mask,
)

__all__ = [
    "center_prior_saliency",
    "get_saliency_fn",
    "importance_scores",
    "motion_contrast_saliency",
    "register_saliency",
    "removability_scores",
    "saliency_to_block_mask",
    "spatial_temporal_complexity",
]
