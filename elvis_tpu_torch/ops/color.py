"""Colour conversions (port of ``elvis_tpu.ops.color``): RGB <-> YCbCr and
grey, and planar YUV 4:2:0 for the codec.

Full-range BT.601 coefficients (identical to OpenCV's YCrCb):
  Y  = 0.299 R + 0.587 G + 0.114 B
  Cb = (B - Y) * 0.564 + 128
  Cr = (R - Y) * 0.713 + 128
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_gray", "rgb_to_ycbcr", "ycbcr_to_rgb", "rgb_to_yuv420", "yuv420_to_rgb"]


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


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    x = ycc.float()
    y, cb, cr = x[..., 0], x[..., 1] - 128.0, x[..., 2] - 128.0
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    out = torch.stack([r, g, b], dim=-1)
    if not ycc.dtype.is_floating_point:
        return _back_to_int(out, ycc.dtype)
    return out


def rgb_to_yuv420(rgb: torch.Tensor):
    """``(N, H, W, 3) -> (Y (N,H,W), Cb (N,H/2,W/2), Cr (N,H/2,W/2))``,
    chroma 2x2 box-subsampled (H and W even). Integer inputs come back
    rounded and clipped in their own type."""
    ycc = rgb_to_ycbcr(rgb.float())
    y = ycc[..., 0]
    n, h, w = y.shape
    cb = ycc[..., 1].reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    cr = ycc[..., 2].reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    if not rgb.dtype.is_floating_point:
        return tuple(_back_to_int(a, rgb.dtype) for a in (y, cb, cr))
    return y, cb, cr


def yuv420_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_yuv420 with nearest-neighbour chroma upsampling."""

    def up(c):
        return c.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)

    out = ycbcr_to_rgb(torch.stack([y.float(), up(cb).float(), up(cr).float()], dim=-1))
    if not y.dtype.is_floating_point:
        return _back_to_int(out, y.dtype)
    return out.to(y.dtype)
