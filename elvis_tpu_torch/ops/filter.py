"""Separable Gaussian filtering (port of ``elvis_tpu.ops.filter``).

1-D correlations along rows then columns with OpenCV reflect-101 borders
(``gfedcb|abcdefgh|gfedcba``, which keeps bouncing for pads longer than
the signal — not ``torch``'s ``reflect`` padding).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["gaussian_kernel_1d", "gaussian_blur"]


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(ksize: int = 5, sigma: float = 1.0) -> np.ndarray:
    """Matches cv2.getGaussianKernel for explicit sigma: exp(-x^2/2s^2), normalized."""
    half = (ksize - 1) / 2
    x = np.arange(ksize) - half
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float64)


@functools.lru_cache(maxsize=256)
def _reflect101_indices(n: int, pad: int) -> np.ndarray:
    """Index row implementing OpenCV borderInterpolate(BORDER_REFLECT_101)
    for arbitrary pad."""

    def bounce(i: int) -> int:
        if n == 1:
            return 0
        while i < 0 or i >= n:
            i = -i if i < 0 else 2 * (n - 1) - i
        return i

    return np.asarray([bounce(i) for i in range(-pad, n + pad)], dtype=np.int32)


def _reflect101_pad(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    idx = torch.as_tensor(_reflect101_indices(x.shape[axis], pad).astype(np.int64),
                          device=x.device)
    return torch.index_select(x, axis, idx)


def _conv1d_along(x: torch.Tensor, kernel: torch.Tensor, axis: int) -> torch.Tensor:
    """Correlate along one axis with reflect-101 padding, same output size."""
    k = kernel.shape[0]
    xp = _reflect101_pad(x, (k - 1) // 2, axis)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + kernel[i] * xp.narrow(axis, i, x.shape[axis]).float()
    return out


def gaussian_blur(images: torch.Tensor, ksize: int = 5, sigma: float = 1.0, *,
                  h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """Separable Gaussian blur over ``(..., H, W, C)`` (default axes)."""
    kern = torch.as_tensor(gaussian_kernel_1d(ksize, sigma), dtype=torch.float32,
                           device=images.device)
    nd = images.dim()
    y = _conv1d_along(images, kern, nd + h_axis if h_axis < 0 else h_axis)
    y = _conv1d_along(y, kern, nd + w_axis if w_axis < 0 else w_axis)
    if not images.dtype.is_floating_point:
        y = torch.clamp(torch.round(y), 0, 255)
    return y.to(images.dtype)
