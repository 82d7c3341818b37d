"""Separable filtering: Gaussian blur, unsharp mask, Sobel energy (port of
``elvis_tpu.ops.filter``).

1-D correlations along rows then columns with OpenCV reflect-101 borders
(``gfedcb|abcdefgh|gfedcba``, which keeps bouncing for pads longer than
the signal — not ``torch``'s ``reflect`` padding). Integer inputs come
back rounded half-to-even, clipped to [0, 255] and in their own type.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "gaussian_kernel_1d",
    "gaussian_blur",
    "iterated_gaussian_blur_levels",
    "unsharp_mask",
    "sobel_energy",
]


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
    return _to_input_type(y, images.dtype)


def _to_input_type(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float32 ``y`` back in ``dtype``: integer types rounded and clipped."""
    if not dtype.is_floating_point:
        y = torch.clamp(torch.round(y), 0, 255)
    return y.to(dtype)


def iterated_gaussian_blur_levels(images: torch.Tensor, max_rounds: int, ksize: int = 5,
                                  sigma: float = 1.0, **axes) -> torch.Tensor:
    """``(max_rounds+1, ...)``: level i is the blur applied i times, each
    round on the previous one's float32 values (no rounding between
    rounds), then rounded once for integer inputs."""
    cur = images.float()
    levels = [cur]
    for _ in range(max_rounds):
        cur = gaussian_blur(cur, ksize, sigma, **axes)
        levels.append(cur)
    return _to_input_type(torch.stack(levels, dim=0), images.dtype)


def unsharp_mask(images: torch.Tensor, amount, radius: int = 1, sigma: float = 1.0,
                 **axes) -> torch.Tensor:
    """``(1 + a) * img - a * blur(img)`` with a ``2 * radius + 1`` kernel;
    ``amount`` is a scalar or an array broadcastable against the images
    (one amount per block, for instance)."""
    x = images.float()
    blurred = gaussian_blur(x, 2 * int(radius) + 1, sigma, **axes)
    a = torch.as_tensor(amount, dtype=torch.float32, device=images.device)
    return _to_input_type((1.0 + a) * x - a * blurred, images.dtype)


_SOBEL_D = np.array([-1.0, 0.0, 1.0])
_SOBEL_S = np.array([1.0, 2.0, 1.0])


def sobel_energy(gray: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude energy ``|Gx| + |Gy|`` of ``(..., H, W)`` luma,
    float32."""
    d = torch.as_tensor(_SOBEL_D, dtype=torch.float32, device=gray.device)
    s = torch.as_tensor(_SOBEL_S, dtype=torch.float32, device=gray.device)
    x = gray.float()
    h_axis, w_axis = gray.dim() - 2, gray.dim() - 1
    gx = _conv1d_along(_conv1d_along(x, d, w_axis), s, h_axis)
    gy = _conv1d_along(_conv1d_along(x, d, h_axis), s, w_axis)
    return gx.abs() + gy.abs()
