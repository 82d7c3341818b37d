"""Stage-boundary pixel type (port of ``elvis_tpu.utils.transfer``).

:func:`as_pixels_u8` wraps a frame function so that its float pixel output
leaves as uint8 (round half-to-even, clip to [0, 255] on the device): the
domain every consumer works in anyway (codec input, metrics against a uint8
reference, PNG artifacts). The JAX module's ``pull`` (device-to-host copies
in slices sized for a TPU link) has no counterpart: the port's clip stays on
the device and a stage that needs a host copy takes it in one ``.cpu()``.
"""

from __future__ import annotations

import torch

__all__ = ["as_pixels_u8"]


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
