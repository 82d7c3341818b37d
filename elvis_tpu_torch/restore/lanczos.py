"""Per-block Lanczos restore, the no-model benchmark restorer (port of
``elvis_tpu.restore.lanczos``).

Per degraded block, re-simulate the area downscale to ``b / 2^level`` then
upscale back with Lanczos-4: one per-block matrix transform with gathered
``Up_lanczos @ Down_area`` operators, the same formulation as the
degradation ops.
"""

from __future__ import annotations

import numpy as np
import torch

from elvis_tpu_torch.degrade.adaptive import _apply_table
from elvis_tpu_torch.kernels.block_transform import resample_matrix_table
from elvis_tpu_torch.ops.resize import resize_matrix
from elvis_tpu_torch.restore.registry import register_restorer

__all__ = ["restore_downsample_lanczos", "restore_downsample_scale_lanczos"]


@register_restorer("downsample", "lanczos")
def restore_downsample_lanczos(frames: torch.Tensor, level_maps: torch.Tensor,
                               block_size: int) -> torch.Tensor:
    """frames ``(N,H,W,C)`` degraded, level_maps ``(N,By,Bx)`` int ->
    restored frames in the input dtype."""
    return _apply_table(frames, resample_matrix_table(block_size, "lanczos4"),
                        level_maps, block_size)


@register_restorer("downsample_scale", "lanczos")
def restore_downsample_scale_lanczos(frames: torch.Tensor, scale_maps: torch.Tensor,
                                     block_size: int, max_scale: int = 4) -> torch.Tensor:
    """Scale-factor counterpart: per degraded block, re-simulate the area
    downscale to ``b / scale`` (any integer scale) then Lanczos-upscale
    back. Indexed like ``degrade.adaptive_downsample_scale``'s operator
    table (0 and 1 = identity)."""
    b = block_size
    ops = [np.eye(b), np.eye(b)]
    for s in range(2, max_scale + 1):
        small = max(1, b // s)
        ops.append(resize_matrix(b, small, "lanczos4") @ resize_matrix(small, b, "area"))
    return _apply_table(frames, np.stack(ops, axis=0), scale_maps, b)
