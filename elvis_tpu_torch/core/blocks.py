"""Block algebra (port of ``elvis_tpu.core.blocks``).

Layout convention: images are channel-last ``(..., H, W, C)``; the block
view is ``(..., By, Bx, b, b, C)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "block_grid_shape",
    "split_into_blocks",
    "combine_blocks",
    "upsample_map",
    "blockwise_reduce",
]


def block_grid_shape(height: int, width: int, block_size: int) -> Tuple[int, int]:
    """Number of (By, Bx) whole blocks covering an H x W frame."""
    if height % block_size or width % block_size:
        raise ValueError(
            f"Frame {height}x{width} not divisible by block_size={block_size}"
        )
    return height // block_size, width // block_size


def split_into_blocks(images: torch.Tensor, block_size: int) -> torch.Tensor:
    """``(..., H, W, C) -> (..., By, Bx, b, b, C)`` (a permuted view)."""
    *lead, h, w, c = images.shape
    by, bx = block_grid_shape(h, w, block_size)
    x = images.reshape(*lead, by, block_size, bx, block_size, c)
    n = len(lead)
    return x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)


def combine_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """``(..., By, Bx, b, b, C) -> (..., H, W, C)``. Inverse of split_into_blocks."""
    *lead, by, bx, b, b2, c = blocks.shape
    if b != b2:
        raise ValueError(f"non-square blocks {b}x{b2}")
    n = len(lead)
    x = blocks.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, by * b, bx * b, c)


def upsample_map(block_map: torch.Tensor, block_size: int) -> torch.Tensor:
    """``(..., By, Bx) -> (..., By*b, Bx*b)`` by nearest-neighbour repetition."""
    x = torch.repeat_interleave(block_map, block_size, dim=-1)
    return torch.repeat_interleave(x, block_size, dim=-2)


def blockwise_reduce(images: torch.Tensor, block_size: int, reducer, *,
                     with_channels: bool = False) -> torch.Tensor:
    """Apply ``reducer(x, dim=...)`` over each block's pixels.

    ``(..., H, W) -> (..., By, Bx)``; with ``with_channels=True`` the input
    is ``(..., H, W, C)`` and channels are reduced too. ``reducer`` takes a
    ``dim`` tuple (e.g. ``torch.mean``, ``torch.amax``).
    """
    if with_channels:
        *lead, h, w, c = images.shape
        by, bx = block_grid_shape(h, w, block_size)
        x = images.reshape(*lead, by, block_size, bx, block_size, c)
        return reducer(x, dim=(-4, -2, -1))
    *lead, h, w = images.shape
    by, bx = block_grid_shape(h, w, block_size)
    x = images.reshape(*lead, by, block_size, bx, block_size)
    return reducer(x, dim=(-3, -1))
