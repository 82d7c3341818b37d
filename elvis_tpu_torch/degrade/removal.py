"""ELVIS v1 selective block removal (port of ``elvis_tpu.degrade.removal``).

  * per row, remove the ``k = int(shrink_amount * Bx)`` blocks with the
    HIGHEST removability (ties by lower index);
  * the shrunk frame is the kept blocks of each row packed left in their
    original order -- width shrinks by ``k`` blocks uniformly;
  * ``stretch_frames`` scatters kept blocks back to mask==0 positions on a
    black canvas.

``k`` is the same for every frame and row, so the whole clip is one gather.
With a cooldown the selection carries per-block protection from frame to
frame: a Python loop over frames on the device.
"""

from __future__ import annotations

import torch

from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks

__all__ = [
    "removal_blocks_per_row", "removal_mask_from_scores",
    "apply_removal_mask", "apply_selective_removal", "stretch_frames",
]


def removal_blocks_per_row(num_blocks_x: int, shrink_amount: float) -> int:
    """Static per-row removal count."""
    if shrink_amount < 1.0:
        k = int(shrink_amount * num_blocks_x)
    else:
        k = int(shrink_amount)
    return min(k, num_blocks_x)


def apply_selective_removal(frames: torch.Tensor, scores: torch.Tensor, block_size: int,
                            shrink_amount: float, cooldown: int = 0):
    """frames ``(N,H,W,C)``, scores ``(N,By,Bx)`` ->
    ``(shrunk (N,H,W-k*b,C), removal_mask (N,By,Bx) int8)``.

    ``cooldown`` > 0: a block removed at frame t is protected from removal
    for the next ``cooldown`` frames (a dominating score penalty, so the
    protection is soft when a row has fewer than k unprotected blocks)."""
    bx = frames.shape[2] // block_size
    mask = removal_mask_from_scores(scores, bx, shrink_amount, cooldown)
    k = removal_blocks_per_row(bx, shrink_amount)
    return apply_removal_mask(frames, mask, block_size, k), mask


def _top_k_mask(eff: torch.Tensor, k: int) -> torch.Tensor:
    """int8 mask of the k largest entries along the last axis, ties to the
    lower index (a stable ascending sort of the negated scores)."""
    removed_idx = torch.argsort(-eff, dim=-1, stable=True)[..., :k]
    mask = torch.zeros(eff.shape, dtype=torch.int8, device=eff.device)
    return mask.scatter_(-1, removed_idx, 1)


def removal_mask_from_scores(scores: torch.Tensor, num_blocks_x: int, shrink_amount: float,
                             cooldown: int = 0) -> torch.Tensor:
    """scores ``(N,By,Bx)`` -> removal mask ``(N,By,Bx)`` int8 (1=removed).

    Computed over the WHOLE clip at once (the cooldown carries state across
    frames); the pipeline then shrinks frames in chunks against it."""
    n, by, bx = scores.shape
    k = removal_blocks_per_row(num_blocks_x, shrink_amount)
    if k == 0:
        return torch.zeros((n, by, bx), dtype=torch.int8, device=scores.device)
    if cooldown and cooldown > 0 and n > 1:
        # a penalty dominating any score difference: protected blocks lose
        # to every unprotected one but rank among themselves by score
        span = (scores.max() - scores.min()) + 1.0
        cd = torch.zeros((by, bx), dtype=torch.int32, device=scores.device)
        out = []
        for t in range(n):
            m = _top_k_mask(scores[t] - span * (cd > 0), k)
            cd = torch.where(m.bool(), cooldown, torch.clamp(cd - 1, min=0))
            out.append(m)
        return torch.stack(out)
    return _top_k_mask(scores, k)


def apply_removal_mask(frames: torch.Tensor, mask: torch.Tensor, block_size: int,
                       removed_per_row: "int | None" = None) -> torch.Tensor:
    """Shrink ``frames`` against a precomputed removal mask (every row
    carries the same removal count). ``removed_per_row`` defaults to the
    count of the mask's first row."""
    blocks = split_into_blocks(frames, block_size)  # (N,By,Bx,b,b,C)
    bx = blocks.shape[2]
    if removed_per_row is None:
        removed_per_row = int(mask[0, 0].sum())
    if removed_per_row == 0:
        return frames
    # kept columns in original order: sort the indices with removed ones
    # pushed past the end, take the first Bx-k
    col = torch.arange(bx, dtype=torch.int32, device=frames.device)
    sort_key = torch.where(mask.bool(), col + bx, col)  # (N,By,Bx)
    kept_idx = torch.sort(sort_key, dim=-1).values[..., : bx - removed_per_row].long()
    idx = kept_idx[..., None, None, None].expand(*kept_idx.shape, *blocks.shape[3:])
    return combine_blocks(torch.gather(blocks, 2, idx))


def stretch_frames(shrunk: torch.Tensor, removal_mask: torch.Tensor,
                   block_size: int) -> torch.Tensor:
    """Inverse scatter: kept blocks fill mask==0 positions in raster order
    per row; removed positions stay black.

    shrunk ``(N,H,W',C)``, removal_mask ``(N,By,Bx)`` -> ``(N,H,W,C)``."""
    blocks = split_into_blocks(shrunk, block_size)  # (N,By,Bx',b,b,C)
    bxs = blocks.shape[2]
    keep = removal_mask == 0
    # for original column j: its source in the shrunk row is the number of
    # kept columns strictly before j (only valid where keep)
    src = torch.clamp(torch.cumsum(keep.to(torch.int64), dim=-1) - 1, 0, bxs - 1)
    idx = src[..., None, None, None].expand(*src.shape, *blocks.shape[3:])
    scattered = torch.gather(blocks, 2, idx)
    scattered = scattered * keep[..., None, None, None].to(scattered.dtype)
    return combine_blocks(scattered)
