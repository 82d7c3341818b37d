from elvis_tpu_torch.ops.color import (
    rgb_to_gray,
    rgb_to_ycbcr,
    rgb_to_yuv420,
    ycbcr_to_rgb,
    yuv420_to_rgb,
)
from elvis_tpu_torch.ops.dct import block_dct2, block_idct2, dct_matrix
from elvis_tpu_torch.ops.filter import gaussian_blur, gaussian_kernel_1d
from elvis_tpu_torch.ops.motion import block_motion
from elvis_tpu_torch.ops.resize import resize

__all__ = [
    "block_dct2",
    "block_idct2",
    "block_motion",
    "dct_matrix",
    "gaussian_blur",
    "gaussian_kernel_1d",
    "resize",
    "rgb_to_gray",
    "rgb_to_ycbcr",
    "rgb_to_yuv420",
    "ycbcr_to_rgb",
    "yuv420_to_rgb",
]
