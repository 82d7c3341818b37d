"""Device-to-host copies and the stage-boundary pixel type (port of
``elvis_tpu.utils.transfer``).

:func:`pull` copies a tensor to a numpy array of the same dtype and bits.
The JAX module's ``pull`` cuts a large copy into slices of the first axis,
because one large pull over its TPU link ran an order of magnitude slower;
a card's copy over PCIe has no such penalty, so this one copies in one
piece. :func:`as_pixels_u8` wraps a frame function so that its float pixel
output leaves as uint8 (round half-to-even, clip to [0, 255] on the
device): the domain every consumer works in anyway (codec input, metrics
against a uint8 reference, PNG artifacts).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pull", "as_pixels_u8"]


def pull(x) -> np.ndarray:
    """``x`` (a tensor on any device, or a numpy array) as a numpy array of
    its dtype and bits, in one copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_pixels_u8(fn):
    """``fn(*args) -> frames`` wrapped so the frames come out uint8."""

    def wrapped(*args):
        out = fn(*args)
        if not out.dtype.is_floating_point:
            return out.to(torch.uint8)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)

    # propagate the tiling/budget contracts the chunk drivers read
    for attr in ("spatial_halo_rows", "spatial_pixel_budget", "temporal_overlap"):
        if hasattr(fn, attr):
            setattr(wrapped, attr, getattr(fn, attr))
    return wrapped
