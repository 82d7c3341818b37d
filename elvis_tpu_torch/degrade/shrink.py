"""PRESLEY shrink methods: greedy sequential block removal (port of
``elvis_tpu.degrade.shrink``).

Every removal shifts the indices after it, so the removal schedule has a
loop-carried dependence. It is split in two, as in the JAX package:

  * the *decision* replay (argmin and shift over the small ``(By, Bx)``
    importance grid) runs in numpy on the host;
  * the *pixel* movement is one gather (shrink) or scatter (stretch) over
    the block tensor on the frames' device, driven by the position map the
    replay produced.

The three reference methods (row only, position map, removal indices)
share that one primitive: 'row_only' removes one block per row per pass;
'row_col' alternates row and column passes (the position-map and
removal-indices methods share its schedule and differ only in the metadata
they record).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks

__all__ = [
    "ShrinkPlan",
    "plan_shrink",
    "shrink_frame",
    "stretch_frame",
    "shrink_video",
    "stretch_video",
]


class ShrinkPlan:
    """Host-side replay result for one frame.

    Attributes:
      removal_mask: (By, Bx) bool, True = removed.
      position_map: (By', Bx', 2) int32, the original (y, x) of each kept
        block of the shrunk grid (the gather map of every method).
      removal_indices: list of int32 arrays, each pass's removed indices.
      shrunk_grid: (By', Bx').
    """

    def __init__(self, removal_mask, position_map, removal_indices, shrunk_grid):
        self.removal_mask = removal_mask
        self.position_map = position_map
        self.removal_indices = removal_indices
        self.shrunk_grid = shrunk_grid


def plan_shrink(importance: np.ndarray, shrink_amount: float,
                method: str = "row_only") -> ShrinkPlan:
    """Replay the greedy removal on the (By, Bx) importance grid:
    ``int(By * Bx * shrink_amount)`` blocks, least important first.
    ``method``: 'row_only' or 'row_col'."""
    imp = np.asarray(importance, dtype=np.float64).copy()
    by0, bx0 = imp.shape
    pos = np.stack(np.meshgrid(np.arange(by0), np.arange(bx0), indexing="ij"), axis=-1)
    removal_mask = np.zeros((by0, bx0), dtype=bool)
    removal_indices: List[np.ndarray] = []
    target = int(by0 * bx0 * shrink_amount)
    removed = 0
    blocks_y, blocks_x = by0, bx0

    def row_pass():
        nonlocal removed, blocks_x
        idxs = []
        complete = True
        for by in range(blocks_y):
            if removed >= target:
                complete = False
                break
            least = int(np.argmin(imp[by, :blocks_x]))
            idxs.append(least)
            oy, ox = pos[by, least]
            removal_mask[oy, ox] = True
            imp[by, least:blocks_x - 1] = imp[by, least + 1:blocks_x]
            pos[by, least:blocks_x - 1] = pos[by, least + 1:blocks_x]
            removed += 1
        if idxs:
            removal_indices.append(np.asarray(idxs, dtype=np.int32))
        if complete:
            blocks_x -= 1

    def col_pass():
        nonlocal removed, blocks_y
        idxs = []
        complete = True
        for bx in range(blocks_x):
            if removed >= target:
                complete = False
                break
            least = int(np.argmin(imp[:blocks_y, bx]))
            idxs.append(least)
            oy, ox = pos[least, bx]
            removal_mask[oy, ox] = True
            imp[least:blocks_y - 1, bx] = imp[least + 1:blocks_y, bx]
            pos[least:blocks_y - 1, bx] = pos[least + 1:blocks_y, bx]
            removed += 1
        if idxs:
            removal_indices.append(np.asarray(idxs, dtype=np.int32))
        if complete:
            blocks_y -= 1

    if method == "row_only":
        while removed < target and blocks_x > 1:
            row_pass()
    elif method == "row_col":
        while removed < target:
            row_pass()
            if removed >= target:
                break
            col_pass()
    else:
        raise ValueError(f"unknown shrink method {method!r}")

    position_map = pos[:blocks_y, :blocks_x].astype(np.int32)
    return ShrinkPlan(removal_mask, position_map, removal_indices, (blocks_y, blocks_x))


def _flat_index(plans: List[ShrinkPlan], device) -> torch.Tensor:
    """``(N, By'*Bx')`` flat original block index of each kept block."""
    bx0 = plans[0].removal_mask.shape[1]
    pm = np.stack([p.position_map for p in plans]).astype(np.int64)
    return torch.as_tensor((pm[..., 0] * bx0 + pm[..., 1]).reshape(len(plans), -1),
                           device=device)


def shrink_video(frames: torch.Tensor, importances: np.ndarray, block_size: int,
                 shrink_amount: float, method: str = "row_only"
                 ) -> Tuple[torch.Tensor, List[ShrinkPlan]]:
    """Per-frame plans on the host, then one gather of the kept blocks of
    every frame on the frames' device. The greedy schedule depends only on
    ``(By, Bx, shrink_amount)``, so every frame's shrunk grid is the same."""
    plans = [plan_shrink(importances[i], shrink_amount, method)
             for i in range(frames.shape[0])]
    blocks = split_into_blocks(frames, block_size)  # (N,By,Bx,b,b,C)
    n = blocks.shape[0]
    flat = blocks.reshape((n, -1) + tuple(blocks.shape[3:]))
    idx = _flat_index(plans, frames.device)
    gathered = flat[torch.arange(n, device=frames.device)[:, None], idx]
    return combine_blocks(gathered.reshape((n,) + plans[0].shrunk_grid
                                           + tuple(blocks.shape[3:]))), plans


def stretch_video(shrunk: torch.Tensor, plans: List[ShrinkPlan],
                  block_size: int) -> torch.Tensor:
    """Scatter the shrunk blocks of every frame back to their original
    positions in one scatter; removed blocks are black. This is the inverse
    of all three reference methods (the removal-indices replay is how a
    client derives the same map)."""
    by0, bx0 = plans[0].removal_mask.shape
    blocks = split_into_blocks(shrunk, block_size)  # (N,By',Bx',b,b,C)
    n = blocks.shape[0]
    src = blocks.reshape((n, -1) + tuple(blocks.shape[3:]))
    canvas = torch.zeros((n, by0 * bx0) + tuple(blocks.shape[3:]), dtype=shrunk.dtype,
                         device=shrunk.device)
    canvas[torch.arange(n, device=shrunk.device)[:, None], _flat_index(plans, shrunk.device)] = src
    return combine_blocks(canvas.reshape((n, by0, bx0) + tuple(blocks.shape[3:])))


def shrink_frame(frame: torch.Tensor, plan: ShrinkPlan, block_size: int) -> torch.Tensor:
    """One frame's kept blocks, gathered by the plan's position map."""
    blocks = split_into_blocks(frame[None], block_size)
    flat = blocks.reshape((-1,) + tuple(blocks.shape[3:]))
    idx = _flat_index([plan], frame.device)[0]
    return combine_blocks(flat[idx].reshape(plan.shrunk_grid + tuple(blocks.shape[3:])))


def stretch_frame(shrunk: torch.Tensor, plan: ShrinkPlan, block_size: int) -> torch.Tensor:
    """One frame's blocks scattered back to their original positions."""
    return stretch_video(shrunk[None], [plan], block_size)[0]
