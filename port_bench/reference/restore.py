"""Plain reference of the progressive restore (ELVIS's client side).

For a degraded segment with block levels (factor ``2**level``) and the
largest level ``L``: box-average the segment to ``1/2**L``; then ``L``
times, upscale 2x with the net and put back, at the new resolution, every
block whose factor is at most the current one, from the degraded segment
box-averaged to that resolution; round to uint8 at the end. One frame at a
time, so the float32 activations of the widest stage fit beside the rest.
"""

from __future__ import annotations

import torch

from port_bench.reference.resize import box_down


def restore_frame(net, frame: torch.Tensor, levels: torch.Tensor, block: int,
                  max_level: int) -> torch.Tensor:
    """uint8 ``(H, W, 3)`` and int ``(By, Bx)`` -> uint8 ``(H, W, 3)``."""
    x = frame[None].float()
    cur = box_down(x, 2**max_level)
    factor = 2**max_level
    for _ in range(max_level):
        factor //= 2
        cur = net(cur)
        keep = (2 ** levels.long()) <= factor
        cell = block // factor
        pix = keep.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[None, ..., None]
        cur = torch.where(pix, box_down(x, factor), cur)
    return torch.clamp(torch.round(cur[0]), 0, 255).to(torch.uint8)


def restore_segment(net, frames: torch.Tensor, levels: torch.Tensor, block: int) -> torch.Tensor:
    max_level = int(levels.max())
    return torch.stack([restore_frame(net, frames[i], levels[i], block, max_level)
                        for i in range(frames.shape[0])])
