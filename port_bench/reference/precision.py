"""The controls' precisions, emulated on any device: the step below the
precision a configuration states."""

from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest value with a 10-bit mantissa, as the
    tensor cores' TF32 inputs are (the step below float32 with TF32 off)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor, back in float32 (the step
    below bfloat16)."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
