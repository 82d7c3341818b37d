"""Spatial/temporal block complexity (port of ``elvis_tpu.scoring.complexity``).

SC is the frequency-weighted DCT energy of each block's luma; TC the same
of the first difference of consecutive frames (TC[0] = 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from elvis_tpu_torch.core.blocks import split_into_blocks
from elvis_tpu_torch.ops.color import rgb_to_gray
from elvis_tpu_torch.ops.dct import block_dct2

__all__ = ["Complexity", "spatial_temporal_complexity", "texture_energy"]


class Complexity(NamedTuple):
    SC: torch.Tensor  # (N, By, Bx) spatial complexity
    TC: torch.Tensor  # (N, By, Bx) temporal complexity; TC[0] == 0


@functools.lru_cache(maxsize=16)
def _freq_weights(b: int) -> np.ndarray:
    """Low-frequency de-emphasis: w(u,v) grows with radius, DC weight 0."""
    u = np.arange(b, dtype=np.float64)
    w = np.sqrt(u[:, None] ** 2 + u[None, :] ** 2)
    w[0, 0] = 0.0
    return (w / w.max()).astype(np.float64)


def texture_energy(gray: torch.Tensor, block_size: int) -> torch.Tensor:
    """``(N, H, W)`` luma -> ``(N, By, Bx)`` frequency-weighted DCT energy."""
    blocks = split_into_blocks(gray[..., None], block_size)[..., 0]  # (N,By,Bx,b,b)
    coeffs = block_dct2(blocks.float())
    w = torch.as_tensor(_freq_weights(block_size), dtype=torch.float32, device=gray.device)
    return (torch.abs(coeffs) * w).sum(dim=(-2, -1)) / (block_size * block_size)


def spatial_temporal_complexity(frames: torch.Tensor, block_size: int) -> Complexity:
    """frames ``(N, H, W, C)`` RGB -> per-block SC/TC."""
    gray = rgb_to_gray(frames.float())
    sc = texture_energy(gray, block_size)
    tc_tail = texture_energy(gray[1:] - gray[:-1], block_size)
    tc = torch.cat([torch.zeros_like(sc[:1]), tc_tail], dim=0)
    return Complexity(SC=sc, TC=tc)
