from elvis_tpu_torch.metrics.pixel import (
    mask_union_bbox,
    masked_mse,
    masked_psnr,
    masked_ssim,
    ssim,
)

__all__ = ["mask_union_bbox", "masked_mse", "masked_psnr", "masked_ssim", "ssim"]
