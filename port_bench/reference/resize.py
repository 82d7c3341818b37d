"""Plain resampling for the reference: the Lanczos-4 2x upscale as dense
matrices (OpenCV's convention: output pixel ``d`` samples the input at
``(d + 0.5) / 2 - 0.5``; eight taps ``sinc(t) sinc(t / 4)`` normalised to
sum 1; edge pixels repeated), and the integer-factor box average.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def lanczos2x_matrix(n: int) -> np.ndarray:
    """``(2n, n)`` float64: the 1-D Lanczos-4 2x upscale of ``n`` samples."""
    mat = np.zeros((2 * n, n))
    for d in range(2 * n):
        c = (d + 0.5) / 2.0 - 0.5
        taps = np.arange(math.floor(c) - 3, math.floor(c) + 5)
        t = np.abs(taps - c)
        w = np.where(t < 1e-9, 1.0, np.sinc(t) * np.sinc(t / 4.0))
        w = np.where(t >= 4.0, 0.0, w)
        w = w / w.sum()
        for i, wi in zip(np.clip(taps, 0, n - 1), w):
            mat[d, i] += wi
    return mat


def lanczos2x(x: torch.Tensor) -> torch.Tensor:
    """float32 ``(N, H, W, C)`` -> ``(N, 2H, 2W, C)``, TF32 off."""
    _, h, w, _ = x.shape
    ah = torch.as_tensor(lanczos2x_matrix(h), dtype=torch.float32, device=x.device)
    aw = torch.as_tensor(lanczos2x_matrix(w), dtype=torch.float32, device=x.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.einsum("oh,nhwc->nowc", ah, x.float())
        return torch.einsum("pw,nhwc->nhpc", aw, y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def box_down(x: torch.Tensor, f: int) -> torch.Tensor:
    """float ``(N, H, W, C)`` averaged over ``f x f`` cells."""
    n, h, w, c = x.shape
    return x.float().reshape(n, h // f, f, w // f, f, c).mean(dim=(2, 4))
