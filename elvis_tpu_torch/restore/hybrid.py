"""Hybrid classical + neural blend (port of ``elvis_tpu.restore.hybrid``).

Blend a cheap classical restore with a neural restore, weighted per block
by the degradation strength: ``out = (1 - a*D) * classical + a*D * neural``
with ``D = level / max_level``.
"""

from __future__ import annotations

from typing import Optional

import torch

from elvis_tpu_torch.core.blocks import upsample_map

__all__ = ["blended_restoration"]


def blended_restoration(classical: torch.Tensor, neural: torch.Tensor,
                        level_maps: torch.Tensor, block_size: int, alpha: float = 0.1,
                        max_level: Optional[int] = None) -> torch.Tensor:
    """``max_level`` defaults to the max of ``level_maps`` (read on the
    host), at least 1. The result has ``classical``'s dtype."""
    if max_level is None:
        max_level = max(int(level_maps.max()), 1)
    d = level_maps.float() / max_level
    w = (alpha * upsample_map(d, block_size))[..., None]
    out = (1.0 - w) * classical.float() + w * neural.float()
    if not classical.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(classical.dtype)
