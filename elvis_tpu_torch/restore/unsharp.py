"""Per-block adaptive unsharp-mask restore for the blur degradation (port
of ``elvis_tpu.restore.unsharp``).

For blur level L > 0: ``amount = 0.5 * L``, ``sigma = max(1, L)``, the
blurred reference is a Gaussian of OpenCV's auto kernel size for 8-bit
images (``round(sigma * 6 + 1) | 1``) with reflect-101 borders inside the
block, and the output is ``(1 + amount) * block - amount * blurred``
clipped to [0, 255]. The per-level Gaussian is a gathered ``(b, b)`` matrix,
so the restore is one per-block matrix transform plus an affine combine.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
from elvis_tpu_torch.kernels.block_transform import (
    apply_block_matrix_fast,
    conv_matrix_reflect101,
)
from elvis_tpu_torch.restore.registry import register_restorer

__all__ = ["restore_blur_unsharp"]


def _auto_ksize(sigma: float) -> int:
    return int(round(sigma * 6 + 1)) | 1


@functools.lru_cache(maxsize=32)
def _unsharp_blur_table(b: int, max_rounds: int) -> np.ndarray:
    """(L+1, b, b): level L -> the Gaussian matrix with sigma = max(1, L);
    level 0 = identity. Kernels longer than the block (61 taps at level 10)
    fold back into it through the reflect-101 bounce."""
    out = [np.eye(b)]
    for lvl in range(1, max_rounds + 1):
        sigma = float(max(1, lvl))
        out.append(conv_matrix_reflect101(b, _auto_ksize(sigma), sigma))
    return np.stack(out, axis=0)


@register_restorer("blur", "unsharp")
def restore_blur_unsharp(frames: torch.Tensor, level_maps: torch.Tensor, block_size: int,
                         max_rounds: int = 10) -> torch.Tensor:
    """frames ``(N,H,W,C)`` blurred, level_maps ``(N,By,Bx)`` blur rounds
    -> sharpened frames in the input dtype; level-0 blocks come back
    bit-exact."""
    blocks = split_into_blocks(frames, block_size).float()
    table = _unsharp_blur_table(block_size, max_rounds)
    blurred = apply_block_matrix_fast(blocks, table, level_maps)
    amount = (0.5 * level_maps.float())[..., None, None, None]
    sharp = torch.clamp((1.0 + amount) * blocks - amount * blurred, 0, 255)
    out = combine_blocks(torch.where(amount > 0, sharp, blocks))
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)
