"""Block algebra (port of ``elvis_tpu.core.blocks``).

Layout convention: images are channel-last ``(..., H, W, C)``; the block
view is ``(..., By, Bx, b, b, C)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "block_grid_shape",
    "split_into_blocks",
    "combine_blocks",
    "upsample_map",
    "downsample_mask",
    "blockwise_reduce",
    "dilate_block_mask",
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


def downsample_mask(pixel_mask: torch.Tensor, block_size: int,
                    threshold: float = 0.5) -> torch.Tensor:
    """Reduce a pixel mask ``(..., H, W)`` to a per-block bool map by
    mean-pooling and thresholding (a block's mean strictly above
    ``threshold``)."""
    *lead, h, w = pixel_mask.shape
    by, bx = block_grid_shape(h, w, block_size)
    x = pixel_mask.reshape(*lead, by, block_size, bx, block_size).float()
    return x.mean(dim=(-3, -1)) > threshold


def dilate_block_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation of a per-block map ``(..., By, Bx)`` by ``radius``
    blocks (Chebyshev / square structuring element), as bool. Shifts do not
    wrap: past the frame edge counts as not removed. ``radius=0`` is the
    identity."""
    out = mask.bool()
    if radius <= 0:
        return out
    by, bx = out.shape[-2], out.shape[-1]
    # max-pool pads with -inf: past the edge never dilates inward
    pooled = F.max_pool2d(out.float().reshape(-1, 1, by, bx), 2 * radius + 1, stride=1,
                          padding=radius)
    return pooled.reshape(out.shape) > 0


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
