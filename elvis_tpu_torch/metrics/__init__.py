from elvis_tpu_torch.metrics.block_ssim import block_ssim_map, fg_bg_ssim
from elvis_tpu_torch.metrics.pixel import (
    mask_union_bbox,
    masked_mse,
    masked_psnr,
    masked_ssim,
    ssim,
)

__all__ = [
    "block_ssim_map",
    "fg_bg_ssim",
    "mask_union_bbox",
    "masked_mse",
    "masked_psnr",
    "masked_ssim",
    "ssim",
]
