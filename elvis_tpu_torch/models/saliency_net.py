"""SaliencyNet — learned foreground segmentation, the UFO slot (port of
``elvis_tpu.models.saliency_net``).

A small UNet over appearance and motion: the input is RGB plus the
magnitude of the difference to the previous frame (the first frame of a
call differences against itself: zero motion), the output a per-pixel
foreground probability. Registered as the ``'neural'`` saliency backend
(``scoring.saliency``).

Public layout is NHWC: frames ``(N, H, W, 3)`` in [0, 255] -> ``(N, H, W)``
float32 in [0, 1]. Numerics mirror the flax model: the body runs in
``dtype`` (bf16 by default: input, kernel and bias cast, bf16 out, as flax
``nn.Conv(dtype=bf16)``), the head in float32 with TF32 off. The two
stride-2 convs pad as flax's ``SAME`` does and the pixel shuffles lay
channels out as ``(dy, dx, c)``: both helpers are the deblur net's. H and W
must be multiples of 4 (the skip concats need the sizes to come back), as
in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.models.deblur_unet import _pixel_shuffle
from elvis_tpu_torch.models.inpaint_net import _conv_nhwc

__all__ = ["SaliencyNet", "make_neural_saliency_fn"]


class SaliencyNet(nn.Module):
    """Parameter names follow the flax tree: ``enc0``, ``down0``, ``down1``,
    ``mid``, ``up1``, ``up0``, ``head``."""

    def __init__(self, features: int = 24, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.dtype = features, dtype
        f = features
        self.enc0 = nn.Conv2d(4, f, 3, padding=1)
        self.down0 = nn.Conv2d(f, 2 * f, 3, stride=2)
        self.down1 = nn.Conv2d(2 * f, 4 * f, 3, stride=2)
        self.mid = nn.Conv2d(4 * f, 4 * f, 3, padding=1)
        self.up1 = nn.Conv2d(4 * f, 8 * f, 3, padding=1)
        self.up0 = nn.Conv2d(4 * f, 4 * f, 3, padding=1)
        self.head = nn.Conv2d(2 * f, 1, 3, padding=1)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.float() / 127.5 - 1.0
        d = torch.cat([torch.zeros_like(x[:1]), x[1:] - x[:-1]])
        motion = torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-8)
        h = torch.cat([x, motion], dim=-1).to(self.dtype)
        dt = self.dtype
        with full_fp32():  # binds only where the body or the head is float32
            h = F.leaky_relu(_conv_nhwc(self.enc0, h, dt), 0.2)
            s0 = h
            h = F.leaky_relu(_conv_nhwc(self.down0, h, dt), 0.2)
            s1 = h
            h = F.leaky_relu(_conv_nhwc(self.down1, h, dt), 0.2)
            h = F.leaky_relu(_conv_nhwc(self.mid, h, dt), 0.2)
            h = torch.cat([_pixel_shuffle(_conv_nhwc(self.up1, h, dt)), s1], dim=-1)
            h = _pixel_shuffle(_conv_nhwc(self.up0, F.leaky_relu(h, 0.2), dt))
            h = torch.cat([h, s0], dim=-1)
            logits = _conv_nhwc(self.head, h.float(), torch.float32)
        return torch.sigmoid(logits[..., 0])


def make_neural_saliency_fn(model: SaliencyNet):
    """A loaded net as a registered-compatible saliency fn: ``frames ->
    (N, H, W)`` float32, without autograd."""

    def fn(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(frames)

    fn.net = model
    return fn
