"""Per-block SSIM map and foreground/background SSIM split (port of
``elvis_tpu.metrics.block_ssim``).

Frames unfold into b x b patches, each an independent SSIM window (a
``(By, Bx)`` map); the map is then averaged over foreground / background
block sets (a block is foreground when its mask fraction >= threshold),
each region defaulting to the overall mean when empty.
"""

from __future__ import annotations

from typing import Tuple

import torch

from elvis_tpu_torch.core.blocks import blockwise_reduce, split_into_blocks
from elvis_tpu_torch.metrics.pixel import ssim
from elvis_tpu_torch.ops.color import rgb_to_gray

__all__ = ["block_ssim_map", "fg_bg_ssim"]


def block_ssim_map(ref: torch.Tensor, dec: torch.Tensor, block_size: int) -> torch.Tensor:
    """``(N,H,W,C)`` pairs -> ``(N,By,Bx)`` per-block SSIM."""
    ref_y = rgb_to_gray(ref.float())
    dec_y = rgb_to_gray(dec.float())
    rb = split_into_blocks(ref_y[..., None], block_size)[..., 0]  # (N,By,Bx,b,b)
    db = split_into_blocks(dec_y[..., None], block_size)[..., 0]
    n, by, bx, b, _ = rb.shape
    win = 7 if b >= 7 else (b if b % 2 == 1 else b - 1)
    vals = ssim(rb.reshape(n * by * bx, b, b), db.reshape(n * by * bx, b, b), win_size=win)
    return vals.reshape(n, by, bx)


def fg_bg_ssim(
    ref: torch.Tensor,
    dec: torch.Tensor,
    fg_mask: torch.Tensor,
    block_size: int,
    fg_threshold: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (overall, fg, bg) scalars over the clip; empty regions default to
    the overall mean."""
    smap = block_ssim_map(ref, dec, block_size)  # (N,By,Bx)
    frac = blockwise_reduce(fg_mask.float(), block_size, torch.mean)
    is_fg = frac >= fg_threshold
    overall = smap.mean()

    def region_mean(sel):
        cnt = sel.float().sum()
        tot = (smap * sel.float()).sum()
        return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1.0), overall)

    return overall, region_mean(is_fg), region_mean(~is_fg)
