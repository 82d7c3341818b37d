"""DeblurUNet — learned blur restoration (port of
``elvis_tpu.models.deblur_unet``).

A compact strength-conditioned UNet: the per-block blur-rounds map enters
as a fourth input plane (``rounds / max_strength``), so one network serves
every blur level. Stride-2 conv down, pixel-shuffle up, skip concats, and
a float32 residual tail over the input.

Public layout stays NHWC: ``(N, H, W, 3)`` in [0, 255] -> the same shape,
float32. Inside, tensors are NHWC with the convs seeing an NCHW view in
channels-last strides (as ``models.srnet`` does). Numerics mirror the flax
model: the body runs in ``dtype`` (bf16 by default; flax
``nn.Conv(dtype=bf16)`` casts input, kernel and bias and returns bf16), the
tail in float32 with TF32 off.

Two places differ from PyTorch's defaults and are written out here:
  * flax pads a stride-2 3x3 ``SAME`` conv by ``(0, 1)`` on an even size
    and ``(1, 1)`` on an odd one (PyTorch's ``padding=1`` is ``(1, 1)``
    always): ``_down`` pads by hand and convolves with ``padding=0``;
  * the flax pixel shuffle lays the up conv's channels out as
    ``(dy, dx, c)`` with ``c`` innermost, not PyTorch's ``(c, dy, dx)``:
    ``_pixel_shuffle`` reshapes by hand in NHWC, so the converted ``up{i}``
    weights keep the flax channel order.

H and W must be multiples of ``2**levels`` (the skip concats need the
sizes to come back), as in the JAX model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.core.blocks import upsample_map
from elvis_tpu_torch.device import full_fp32

__all__ = ["DeblurUNet"]


def _same_pad_stride2(size: int) -> "tuple[int, int]":
    """(before, after) padding of flax/XLA ``SAME`` for kernel 3, stride 2."""
    total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


def _pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC ``(N, H, W, r*r*C)`` with channels ordered ``(dy, dx, c)`` ->
    ``(N, H*r, W*r, C)``."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


class DeblurUNet(nn.Module):
    """Parameter names follow the flax tree: ``enc{i}a``, ``enc{i}b``,
    ``down{i}``, ``mid``, ``up{i}``, ``dec{i}``, ``tail`` (see
    ``models.io.params_from_flax``)."""

    def __init__(self, features: int = 32, levels: int = 3,
                 dtype: torch.dtype = torch.bfloat16, max_strength: float = 10.0):
        super().__init__()
        self.features, self.levels = features, levels
        self.dtype, self.max_strength = dtype, float(max_strength)
        f, cin = features, 4
        for i in range(levels):
            setattr(self, f"enc{i}a", nn.Conv2d(cin, f, 3, padding=1))
            setattr(self, f"enc{i}b", nn.Conv2d(f, f, 3, padding=1))
            setattr(self, f"down{i}", nn.Conv2d(f, f * 2, 3, stride=2))
            f, cin = f * 2, f * 2
        self.mid = nn.Conv2d(f, f, 3, padding=1)
        for i in reversed(range(levels)):
            f //= 2
            setattr(self, f"up{i}", nn.Conv2d(f * 2, f * 4, 3, padding=1))
            setattr(self, f"dec{i}", nn.Conv2d(f * 2, f, 3, padding=1))
        self.tail = nn.Conv2d(features, 3, 3, padding=1)
        nn.init.zeros_(self.tail.weight)  # identity until trained, as in flax

    def _conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, name)
        out = F.conv2d(h.permute(0, 3, 1, 2), conv.weight.to(self.dtype),
                       conv.bias.to(self.dtype), stride=conv.stride, padding=conv.padding)
        return out.permute(0, 2, 3, 1)

    def _down(self, name: str, h: torch.Tensor) -> torch.Tensor:
        top, bottom = _same_pad_stride2(h.shape[1])
        left, right = _same_pad_stride2(h.shape[2])
        # F.pad pads from the last dim backwards: C, then W, then H
        return self._conv(name, F.pad(h, (0, 0, left, right, top, bottom)))

    def _body(self, h: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.levels):
            h = F.leaky_relu(self._conv(f"enc{i}a", h), 0.2)
            h = F.leaky_relu(self._conv(f"enc{i}b", h), 0.2)
            skips.append(h)
            h = self._down(f"down{i}", h)
        h = F.leaky_relu(self._conv("mid", h), 0.2)
        for i in reversed(range(self.levels)):
            h = _pixel_shuffle(self._conv(f"up{i}", h), 2)
            h = torch.cat([h, skips[i]], dim=-1)
            h = F.leaky_relu(self._conv(f"dec{i}", h), 0.2)
        return h

    def forward(self, x: torch.Tensor, strength_map: Optional[torch.Tensor] = None,
                block_size: int = 8) -> torch.Tensor:
        """x ``(N,H,W,3)`` in [0,255]; strength_map ``(N,By,Bx)`` blur rounds."""
        inp = x.float()
        if strength_map is not None:
            s = upsample_map(strength_map.float() / self.max_strength, block_size)[..., None]
        else:
            s = torch.zeros(inp.shape[:-1] + (1,), dtype=torch.float32, device=inp.device)
        h = torch.cat([inp / 127.5 - 1.0, s], dim=-1).to(self.dtype)
        with full_fp32():  # binds only where the body or the tail is float32
            h = self._body(h).float()
            residual = F.conv2d(h.permute(0, 3, 1, 2), self.tail.weight, self.tail.bias,
                                padding=1).permute(0, 2, 3, 1)
        return torch.clamp(inp + 127.5 * residual, 0.0, 255.0)
