"""Block DCT as matrix multiplies (port of ``elvis_tpu.ops.dct``).

A 2-D DCT of a b x b block is ``D @ X @ D.T`` with the orthonormal DCT-II
matrix D, run in float32 with TF32 off (JAX runs it at ``HIGHEST``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elvis_tpu_torch.device import full_fp32

__all__ = ["dct_matrix", "block_dct2"]


@functools.lru_cache(maxsize=16)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix: D[k, i] = s_k * cos(pi/n * (i + 0.5) * k)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi / n * (i + 0.5) * k)
    d[0] *= 1.0 / np.sqrt(2.0)
    return (d * np.sqrt(2.0 / n)).astype(np.float64)


def block_dct2(blocks: torch.Tensor) -> torch.Tensor:
    """2-D DCT over the trailing two spatial axes of ``(..., b, b)``."""
    b = blocks.shape[-1]
    d = torch.as_tensor(dct_matrix(b), dtype=torch.float32, device=blocks.device)
    x = blocks.float()
    with full_fp32():
        y = torch.einsum("kb,...bc->...kc", d, x)
        return torch.einsum("lc,...kc->...kl", d, y)
