"""Restorer for the DCT-dampening degradation, the "ELVIS v2" client side
(port of ``elvis_tpu.restore.dampen``).

The server scaled coefficient (u, v) by a known factor ``a`` (the level
map ships as a sidecar), so the client multiplies by ``min(1/a,
max_gain)``: exact inversion at moderate strengths, capped where
quantization noise would be amplified.
"""

from __future__ import annotations

import torch

from elvis_tpu_torch.degrade.dct_dampen import dampen_attenuation, scale_block_spectra
from elvis_tpu_torch.restore.registry import register_restorer

__all__ = ["restore_dct_dampen_inverse"]


@register_restorer("dct_dampen", "inverse_filter")
def restore_dct_dampen_inverse(frames: torch.Tensor, level_maps: torch.Tensor,
                               block_size: int, levels: int = 10, dampen_gain: float = 8.0,
                               max_gain: float = 4.0) -> torch.Tensor:
    """Invert ``degrade.dct_dampen`` given its level map sidecar."""
    atten = dampen_attenuation(level_maps, block_size, levels, dampen_gain)
    return scale_block_spectra(frames, torch.clamp(1.0 / atten, max=max_gain), block_size)
