"""Temporal blending (port of ``elvis_tpu.restore.temporal``): each
restored frame blended with the previous blended frame,
``out[t] = (1-tb)*frame[t] + tb*out[t-1]`` (a recurrence over the frame
axis: a loop over frames on the device).

The module's halo-tile helpers (``extract_halo_tiles``,
``feathered_tile_apply``) serve the spatial branch and come with it.
"""

from __future__ import annotations

import torch

__all__ = ["temporal_blend"]


def _to_input_type(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if not like.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(like.dtype)


def temporal_blend(frames: torch.Tensor, blend: float = 0.1) -> torch.Tensor:
    """IIR blend along the frame axis (frame 0 unchanged)."""
    if blend <= 0:
        return frames
    x = frames.float()
    out = [x[0]]
    for t in range(1, x.shape[0]):
        out.append((1.0 - blend) * x[t] + blend * out[-1])
    return _to_input_type(torch.stack(out), frames)
