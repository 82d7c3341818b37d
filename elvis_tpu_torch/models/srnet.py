"""SRNetCompact — the conv-stack 2x super-resolution family (port of the
serving tiers of ``elvis_tpu.models.srnet``).

Public layout stays NHWC: ``(N, H, W, 3)`` float32 in [0, 255] ->
``(N, 2H, 2W, 3)``, or the pre-interleave phase tensor ``(N, H, W, 2, 2, 3)``.
Inside, the NHWC input is viewed as NCHW with channels-last strides, the
layout cuDNN's bf16 convolutions prefer.

Numerics mirror the flax model: the trunk runs in ``dtype`` (bf16 by
default; flax ``nn.Conv(dtype=bf16)`` casts input, kernel and bias to bf16
and returns bf16), and the 3x3 residual tail runs in float32 with TF32
off. The output is ``clip(lanczos4_2x(x) + 127.5 * tail(...), 0, 255)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.ops.resize import interleave_phases, resize, upsample2x_phases

__all__ = ["SRNetCompact", "SRNetLarge", "srnet_upsample_fn", "srnet_phase_fn"]


@functools.lru_cache(maxsize=2)
def _phase_kernel_select() -> np.ndarray:
    """Constant selector ``S[ky,kx,pq,ab,dy,dx] in {0,1}`` scattering a 3x3
    full-res kernel into its phase-domain (3,3,4Cin,4Co) form: output pixel
    ``(2i+a+dy, 2j+b+dx)`` of a pixel-shuffled image lives at low-res row
    ``i + (a+dy)//2``, phase ``(a+dy)%2`` (the same for columns)."""
    s = np.zeros((3, 3, 4, 4, 3, 3), np.float32)
    for a in (0, 1):
        for b in (0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ky, p = (a + dy) // 2, (a + dy) % 2
                    kx, q = (b + dx) // 2, (b + dx) % 2
                    s[ky + 1, kx + 1, 2 * p + q, 2 * a + b, dy + 1, dx + 1] = 1.0
    return s


def _nhwc_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3x3 SAME convolution of an NHWC tensor (OIHW weight) -> NHWC."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=1)
    return out.permute(0, 2, 3, 1)


class _TailConv(nn.Module):
    """The float32 3x3 full-resolution residual head, with an exact
    phase-domain mode: a 3x3 conv over the pixel-shuffled image equals a
    3x3 conv over the 4Cin-channel phase tensor with a scattered kernel."""

    def __init__(self, cin: int, features: int = 3):
        super().__init__()
        self.cin, self.features = cin, features
        self.weight = nn.Parameter(torch.zeros(features, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``(N,H,W,Cin)`` -> ``(N,H,W,features)``."""
        with full_fp32():
            return _nhwc_conv(x.float(), self.weight, None) + self.bias

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        """x ``(N,H,W,2,2,Cin)`` -> ``(N,H,W,2,2,features)``."""
        cin, co = self.cin, self.features
        n, hh, ww = x.shape[0], x.shape[1], x.shape[2]
        sel = torch.as_tensor(_phase_kernel_select(), device=x.device)
        with full_fp32():
            hwio = self.weight.permute(2, 3, 1, 0)
            k4 = torch.einsum("uvpayx,yxio->uvpiao", sel, hwio).reshape(3, 3, 4 * cin, 4 * co)
            out = _nhwc_conv(x.float().reshape(n, hh, ww, 4 * cin),
                             k4.permute(3, 2, 0, 1), None)
        return out.reshape(n, hh, ww, 2, 2, co) + self.bias


class SRNetCompact(nn.Module):
    """2x SR conv stack + pixel shuffle, residual over a Lanczos-4 base.

    Parameter names follow the flax tree: ``head``, ``conv{i}``, ``up``,
    ``tail`` (see ``models.io.params_from_flax``).
    """

    def __init__(self, features: int = 128, num_convs: int = 5,
                 dtype: torch.dtype = torch.bfloat16, phase_output: bool = False):
        super().__init__()
        self.features, self.num_convs = features, num_convs
        self.dtype, self.phase_output = dtype, phase_output
        self.head = nn.Conv2d(3, features, 3, padding=1)
        for i in range(num_convs):
            setattr(self, f"conv{i}", nn.Conv2d(features, features, 3, padding=1))
        self.up = nn.Conv2d(features, 12, 3, padding=1)  # 3ch x 2x2 shuffle
        self.tail = _TailConv(cin=3)

    def _conv(self, conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        return _nhwc_conv(h, conv.weight.to(self.dtype), conv.bias.to(self.dtype))

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """``(N,H,W,3)`` -> the up conv's ``(N,H,W,2,2,3)`` in ``dtype``."""
        h = (x.float() / 127.5 - 1.0).to(self.dtype)
        h = F.leaky_relu(self._conv(self.head, h), 0.2)
        for i in range(self.num_convs):
            h = F.leaky_relu(self._conv(getattr(self, f"conv{i}"), h), 0.2)
        h = self._conv(self.up, h)
        n, hh, ww, _ = h.shape
        return h.reshape(n, hh, ww, 2, 2, 3)

    def forward(self, x: torch.Tensor, phase_output: "bool | None" = None) -> torch.Tensor:
        if self.dtype == torch.float32:
            with full_fp32():
                ph = self._trunk(x)
        else:
            ph = self._trunk(x)
        if self.phase_output if phase_output is None else phase_output:
            res = self.tail.phase(ph.float())
            base = upsample2x_phases(x.float(), "lanczos4")
            return torch.clamp(base + 127.5 * res, 0.0, 255.0)
        base = resize(x, (x.shape[-3] * 2, x.shape[-2] * 2), method="lanczos4")
        residual = self.tail(interleave_phases(ph).float())
        return torch.clamp(base.float() + 127.5 * residual, 0.0, 255.0)


def SRNetLarge() -> SRNetCompact:
    """The SRNetCompact architecture scaled to 256ch x 8 convs."""
    return SRNetCompact(features=256, num_convs=8)


def srnet_phase_fn(model: SRNetCompact):
    """(frames) -> (N,H,W,2,2,3) float32 phase tensor of ``model``."""

    def up_phase(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(frames.float(), phase_output=True)

    return up_phase


def srnet_upsample_fn(model: SRNetCompact):
    """Adapter: (frames) -> 2x frames, for the progressive restore loop's
    ``upsample_fn`` slot. The callable carries ``.phase_fn``, the
    pre-interleave variant the loop prefers."""

    def up(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(frames.float(), phase_output=False)

    up.phase_fn = srnet_phase_fn(model)
    return up
