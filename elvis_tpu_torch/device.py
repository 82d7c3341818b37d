"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_fp32"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly for a CPU run"
        )
    return dev


@contextlib.contextmanager
def full_fp32():
    """Float32 matmuls and convolutions at full float32 precision (no TF32)
    inside the block — the counterpart of JAX's ``Precision.HIGHEST``.
    Restores the previous settings on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    # set the one attribute: ``torch.backends.cudnn.flags()`` would also
    # reset ``enabled`` to its own default, False, and send every
    # convolution inside the block past cuDNN
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
