"""Colour conversions (port of ``elvis_tpu.ops.color``).

Full-range BT.601 coefficients (identical to OpenCV's YCrCb):
  Y  = 0.299 R + 0.587 G + 0.114 B
  Cb = (B - Y) * 0.564 + 128
  Cr = (R - Y) * 0.713 + 128
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_gray", "rgb_to_ycbcr"]


def _back_to_int(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.clamp(torch.round(y), 0, 255).to(dtype)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, 3) -> (..., H, W)`` luma (BT.601, cv2.COLOR_RGB2GRAY)."""
    x = rgb.float()
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    if not rgb.dtype.is_floating_point:
        return _back_to_int(y, rgb.dtype)
    return y


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + 128.0
    cr = (r - y) * 0.713 + 128.0
    out = torch.stack([y, cb, cr], dim=-1)
    if not rgb.dtype.is_floating_point:
        return _back_to_int(out, rgb.dtype)
    return out
