"""Adaptive per-block degradation (port of ``elvis_tpu.degrade.adaptive``).

  * downsample: ``level = round(score * log2(b))`` (half-to-even), each
    block area-downsampled to ``b / 2^level`` then linearly upsampled back;
  * blur: ``rounds = round(score * 10)`` iterations of a 5x5 sigma=1
    Gaussian within each block (reflect-101 at block edges).

Both are one per-block matrix transform (``kernels.block_transform``): each
block's level picks a precomputed (b, b) operator, and the whole clip goes
through the kernel in one read and one write, as frames of its own type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from elvis_tpu_torch.kernels.block_transform import (
    apply_table_to_frames,
    blur_matrix_table,
    resample_matrix_table,
)
from elvis_tpu_torch.ops.resize import resize_matrix

__all__ = [
    "downsample_levels_from_scores",
    "blur_levels_from_scores",
    "adaptive_downsample",
    "adaptive_downsample_scale",
    "adaptive_blur",
]


def downsample_levels_from_scores(scores: torch.Tensor, block_size: int) -> torch.Tensor:
    """``(..., By, Bx)`` scores in [0,1] -> int32 levels in [0, log2(b)]
    (``torch.round`` is half-to-even, like ``np.round``/``jnp.round``)."""
    return torch.round(scores * int(math.log2(block_size))).to(torch.int32)


def blur_levels_from_scores(scores: torch.Tensor, max_rounds: int = 10) -> torch.Tensor:
    """``(..., By, Bx)`` scores in [0,1] -> blur rounds in [0, max_rounds]."""
    return torch.round(scores * max_rounds).to(torch.int32)


def _apply_table(frames, table, levels, block_size):
    """Frames through ``table`` by ``levels``, back in their own type
    (integer types rounded half-to-even and clipped to [0, 255])."""
    return apply_table_to_frames(frames, table, levels, block_size)


def adaptive_downsample(frames: torch.Tensor, scores: torch.Tensor, block_size: int):
    """Degrade each block by its score-derived power-of-2 factor.

    frames ``(N, H, W, C)``, scores ``(N, By, Bx)`` in [0,1]. Returns
    ``(degraded (N,H,W,C), level_map (N,By,Bx) int32)``.
    """
    levels = downsample_levels_from_scores(scores, block_size)
    table = resample_matrix_table(block_size, "linear")
    return _apply_table(frames, table, levels, block_size), levels


def adaptive_downsample_scale(frames: torch.Tensor, importance: torch.Tensor,
                              block_size: int, max_scale: int = 4):
    """PRESLEY scale-factor variant: importance binned into ``max_scale``
    levels; scale factor 0 (untouched) or 2..max_scale. Returns
    ``(degraded, scale_map)``."""
    inv = 1.0 - importance
    bins = torch.clamp(torch.floor(inv * max_scale).to(torch.int32), 0, max_scale - 1)
    scale_map = torch.where(bins == 0, 0, bins + 1).to(torch.int32)
    ops = [np.eye(block_size), np.eye(block_size)]  # index 1 unused -> identity
    for s in range(2, max_scale + 1):
        small = max(1, block_size // s)
        ops.append(resize_matrix(block_size, small, "linear")
                   @ resize_matrix(small, block_size, "area"))
    return _apply_table(frames, np.stack(ops, axis=0), scale_map, block_size), scale_map


def adaptive_blur(frames: torch.Tensor, scores: torch.Tensor, block_size: int,
                  max_rounds: int = 10):
    """Blur each block ``round(score*max_rounds)`` times within the block.
    Returns ``(degraded, rounds_map int32)``."""
    levels = blur_levels_from_scores(scores, max_rounds)
    table = blur_matrix_table(block_size, max_rounds)
    return _apply_table(frames, table, levels, block_size), levels
