"""Inpainting restorers for the removal degradation (port of the
``'diffusion'`` slot of ``elvis_tpu.restore.inpaint``).

``diffusion`` is PDE (heat-equation) inpainting: masked Jacobi relaxation
that propagates boundary colours inward -- the niche of OpenCV's Telea fill,
a smooth fill from the hole boundary. Each of the 200 iterations replaces
every hole pixel by the mean of its four neighbours (edge rows and columns
replicated), known pixels pinned. The motion-compensated ``temporal`` slot
and the neural slot are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from elvis_tpu_torch.core.blocks import upsample_map
from elvis_tpu_torch.restore.registry import register_restorer

__all__ = ["restore_removal_diffusion"]


def _masked_jacobi(frames: torch.Tensor, hole: torch.Tensor, iters: int) -> torch.Tensor:
    """Relax hole pixels toward the 4-neighbour mean; known pixels pinned.

    frames float32 ``(N,H,W,C)``, hole bool ``(N,H,W,1)``."""
    known = torch.where(hole, 0.0, frames)
    # start from the mean of the known pixels for faster convergence
    denom = torch.clamp((~hole).sum(dim=(1, 2), keepdim=True), min=1)
    mean = known.sum(dim=(1, 2), keepdim=True) / denom
    x = torch.where(hole, mean, known).permute(0, 3, 1, 2)  # (N,C,H,W)
    hole_c = hole.permute(0, 3, 1, 2)
    known_c = known.permute(0, 3, 1, 2)
    h, w = x.shape[-2], x.shape[-1]
    for _ in range(iters):
        p = F.pad(x, (1, 1, 1, 1), mode="replicate")
        # (up + down + left + right) * 0.25, in the reference's order
        avg = (p[..., 0:h, 1:w + 1] + p[..., 2:h + 2, 1:w + 1] + p[..., 1:h + 1, 0:w]
               + p[..., 1:h + 1, 2:w + 2]) * 0.25
        x = torch.where(hole_c, avg, known_c)
    return x.permute(0, 2, 3, 1)


@register_restorer("removal", "diffusion")
def restore_removal_diffusion(
    frames: torch.Tensor,
    removal_mask: torch.Tensor,
    block_size: int,
    iters: int = 200,
) -> torch.Tensor:
    """frames ``(N,H,W,C)`` stretched (holes black), removal_mask
    ``(N,By,Bx)`` nonzero = removed. Integer frames come back rounded and
    clipped in their own type."""
    hole = upsample_map(removal_mask.bool(), block_size)[..., None]
    out = _masked_jacobi(frames.float(), hole, iters)
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)
