"""Block DCT as matrix multiplies (port of ``elvis_tpu.ops.dct``).

A 2-D DCT of a b x b block is ``D @ X @ D.T`` with the orthonormal DCT-II
matrix D, its inverse ``D.T @ C @ D``; both run in float32 with TF32 off
(JAX runs them at ``HIGHEST``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elvis_tpu_torch.device import full_fp32

__all__ = ["dct_matrix", "block_dct2", "block_idct2"]


@functools.lru_cache(maxsize=16)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix: D[k, i] = s_k * cos(pi/n * (i + 0.5) * k)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi / n * (i + 0.5) * k)
    d[0] *= 1.0 / np.sqrt(2.0)
    return (d * np.sqrt(2.0 / n)).astype(np.float64)


@functools.lru_cache(maxsize=16)
def _dct_tensor(n: int, device: torch.device) -> torch.Tensor:
    """The DCT matrix as a float32 tensor, uploaded once per device."""
    return torch.as_tensor(dct_matrix(n), dtype=torch.float32, device=device)


def block_dct2(blocks: torch.Tensor) -> torch.Tensor:
    """2-D DCT over the trailing two spatial axes of ``(..., b, b)``."""
    b = blocks.shape[-1]
    d = _dct_tensor(b, blocks.device)
    x = blocks.float()
    with full_fp32():
        y = torch.einsum("kb,...bc->...kc", d, x)
        return torch.einsum("lc,...kc->...kl", d, y)


def block_idct2(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT (DCT-III with the orthonormal matrix transposed)."""
    b = coeffs.shape[-1]
    d = _dct_tensor(b, coeffs.device)
    x = coeffs.float()
    with full_fp32():
        y = torch.einsum("kb,...kc->...bc", d, x)
        return torch.einsum("cl,...bc->...bl", d, y)
