"""InpaintNet — learned video inpainting, the E2FGVI slot (port of
``elvis_tpu.models.inpaint_net``).

A compact gated-convolution net that refines a classical fill: the holes
arrive pre-filled by ``restore.inpaint.restore_removal_temporal``, the net
adds a residual inside the holes only. Temporal context is channel-stacked:
the frame, its edge-clamped neighbours at +-1 .. +-``temporal_window`` in
the order ``[x, fwd1, bwd1, fwd2, bwd2, ...]``, and the hole plane.

Public layout is NHWC: frames ``(N, H, W, 3)`` in [0, 255] -> the same
shape, float32. Numerics mirror the flax model: the body runs in ``dtype``
(bf16 by default: input, kernel and bias cast, bf16 out, as flax
``nn.Conv(dtype=bf16)``), the tail in float32 with TF32 off. The stride-2
``down`` conv pads as flax's ``SAME`` does and ``up`` is followed by the
flax pixel shuffle (channels ``(dy, dx, c)``): both helpers are the deblur
net's. H and W must be even.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.core.blocks import upsample_map
from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.models.deblur_unet import _pixel_shuffle, _same_pad_stride2

__all__ = ["GatedConv", "InpaintNet"]


def _conv_nhwc(conv: nn.Conv2d, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on NHWC ``h`` in ``dtype``; a stride-2 conv pads as flax
    ``SAME`` does, by hand."""
    if conv.stride[0] == 2:
        top, bottom = _same_pad_stride2(h.shape[1])
        left, right = _same_pad_stride2(h.shape[2])
        h = F.pad(h, (0, 0, left, right, top, bottom))
    out = F.conv2d(h.permute(0, 3, 1, 2), conv.weight.to(dtype), conv.bias.to(dtype),
                   stride=conv.stride, padding=conv.padding)
    return out.permute(0, 2, 3, 1)


class GatedConv(nn.Module):
    """3x3 conv to ``2 * features`` channels, ``leaky_relu(feat, 0.2) *
    sigmoid(gate)`` of its two halves. The conv is ``Conv_0``, as in the
    flax tree (``<layer>/Conv_0/kernel``)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, 2 * features, 3, stride=stride,
                                padding=0 if stride == 2 else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat, gate = torch.chunk(_conv_nhwc(self.Conv_0, x, self.dtype), 2, dim=-1)
        return F.leaky_relu(feat, 0.2) * torch.sigmoid(gate)


class InpaintNet(nn.Module):
    """Parameter names follow the flax tree: ``enc0``, ``down``,
    ``mid{0,1,2}`` (gated, each ``.Conv_0``), ``up``, ``dec`` (gated),
    ``tail``."""

    def __init__(self, features: int = 32, temporal_window: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.temporal_window, self.dtype = features, temporal_window, dtype
        f = features
        self.enc0 = GatedConv(3 * (1 + 2 * temporal_window) + 1, f, dtype=dtype)
        self.down = GatedConv(f, 2 * f, stride=2, dtype=dtype)
        for i in range(3):
            setattr(self, f"mid{i}", GatedConv(2 * f, 2 * f, dtype=dtype))
        self.up = nn.Conv2d(2 * f, 4 * f, 3, padding=1)
        self.dec = GatedConv(2 * f, f, dtype=dtype)
        self.tail = nn.Conv2d(f, 3, 3, padding=1)
        nn.init.zeros_(self.tail.weight)  # identity until trained, as in flax
        nn.init.zeros_(self.tail.bias)

    def forward(self, frames: torch.Tensor, removal_mask: torch.Tensor,
                block_size: int = 8) -> torch.Tensor:
        """frames ``(N,H,W,3)`` in [0,255] (holes pre-filled), removal_mask
        ``(N,By,Bx)`` nonzero = removed -> refined frames, float32."""
        inp = frames.float()
        x = inp / 127.5 - 1.0
        hole = upsample_map(removal_mask.float(), block_size)[..., None]
        ctx = [x]
        for d in range(1, self.temporal_window + 1):
            fwd = torch.cat([x[d:], x[-1:].expand(d, *x.shape[1:])])
            bwd = torch.cat([x[:1].expand(d, *x.shape[1:]), x[:-d]])
            ctx.extend([fwd, bwd])
        h = torch.cat(ctx + [hole], dim=-1).to(self.dtype)
        with full_fp32():  # binds only where the body or the tail is float32
            h = self.enc0(h)
            skip = h
            h = self.down(h)
            for i in range(3):
                h = getattr(self, f"mid{i}")(h)
            h = _pixel_shuffle(_conv_nhwc(self.up, h, self.dtype), 2)
            h = self.dec(torch.cat([h, skip], dim=-1))
            residual = _conv_nhwc(self.tail, h.float(), torch.float32)
        return torch.clamp(inp + 127.5 * residual * hole, 0.0, 255.0)
