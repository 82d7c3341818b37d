"""DCT-coefficient dampening, the "ELVIS v2" degradation (port of
``elvis_tpu.degrade.dct_dampen``).

For a quantized strength ``s = level / levels`` in [0, 1], coefficient
(u, v) of a block's 2-D DCT is scaled by ``1 / (1 + s * dampen_gain * f)``
with ``f = (u + v) / (2b - 2)`` the normalized frequency radius: DC is
always kept, high frequencies attenuate progressively. The integer level
map is the sidecar the client inverts with (``restore.dampen``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
from elvis_tpu_torch.ops.dct import block_dct2, block_idct2

__all__ = ["dampen_levels_from_scores", "dampen_attenuation", "scale_block_spectra",
           "dct_dampen"]


def dampen_levels_from_scores(scores: torch.Tensor, levels: int = 10) -> torch.Tensor:
    """Scores in [0, 1] -> integer levels ``round(score * levels)`` (half to even)."""
    return torch.round(scores * levels).to(torch.int32)


def dampen_attenuation(level_maps: torch.Tensor, block_size: int, levels: int = 10,
                       dampen_gain: float = 8.0) -> torch.Tensor:
    """``(N,By,Bx)`` levels -> the ``(N,By,Bx,b,b)`` float32 factor each
    block's DCT coefficients were scaled by."""
    u = torch.arange(block_size, dtype=torch.float32, device=level_maps.device)
    f = (u[:, None] + u[None, :]) / (2.0 * (block_size - 1))
    s = level_maps.float() / levels
    return 1.0 / (1.0 + s[..., None, None] * dampen_gain * f)


def scale_block_spectra(frames: torch.Tensor, factors: torch.Tensor,
                        block_size: int) -> torch.Tensor:
    """Each block's 2-D DCT times its ``(b, b)`` factor, back to pixels in
    the input dtype (integer in: rounded half to even and clipped)."""
    blocks = split_into_blocks(frames, block_size)  # (N,By,Bx,b,b,C)
    x = blocks.float().permute(0, 1, 2, 5, 3, 4)  # (N,By,Bx,C,b,b)
    rec = block_idct2(block_dct2(x) * factors[..., None, :, :]).permute(0, 1, 2, 4, 5, 3)
    out = combine_blocks(rec)
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)


def dct_dampen(frames: torch.Tensor, scores: torch.Tensor, block_size: int,
               levels: int = 10, dampen_gain: float = 8.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames ``(N,H,W,C)``, scores ``(N,By,Bx)`` -> ``(degraded, level_map
    (N,By,Bx) int32)``."""
    lvl = dampen_levels_from_scores(scores, levels)
    atten = dampen_attenuation(lvl, block_size, levels, dampen_gain)
    return scale_block_spectra(frames, atten, block_size), lvl
