"""The route a net's convolution takes, shared by every net of the port that
runs its trunk through the hand-written kernels (the SR nets, E2FGVI-HQ).

  * ``nhwc_conv`` — a convolution of an NHWC tensor (OIHW weight) -> NHWC,
    the NHWC tensor viewed as NCHW with channels-last strides (the layout
    cuDNN's bf16 convolutions prefer);
  * ``trunk_conv`` — a trunk conv in its dtype with its epilogue (bias,
    leaky ReLU, scaled residuals): in bf16 inference on a card (no
    autograd) the conv runs without its bias and ``conv_epilogue_cuda``
    applies all of it in one in-place pass, bit-equal to the PyTorch ops it
    replaces; elsewhere (the CPU, float32, gradients) those ops run as
    written. Counters ``nets.epilogue.fused`` and ``.plain``;
  * ``float32_tail`` — a net's float32 3x3 conv to 3 channels: on a bf16
    CUDA tensor with autograd off the ``tail_conv_cuda`` kernel reads the
    bf16 tensor where it lies; elsewhere the caller's plain route. Counters
    ``nets.tail.fused`` and ``.plain``; span ``srnet.tail`` around each call
    (the name from the SR nets, which had the tail first).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.kernels.conv_epilogue import conv_epilogue_cuda, epilogue_rest
from elvis_tpu_torch.kernels.tail_conv import tail_conv_cuda
from elvis_tpu_torch.utils.trace import counter, span

__all__ = ["nhwc_conv", "trunk_conv", "float32_tail", "TAIL_SPAN"]

NETS = counter("nets")
TAIL_SPAN = "srnet.tail"


def nhwc_conv(x: torch.Tensor, weight: torch.Tensor, bias: "torch.Tensor | None", stride=1,
              padding=1, dilation=1, groups: int = 1) -> torch.Tensor:
    """Convolution of an NHWC tensor (OIHW weight) -> NHWC; 3x3 SAME by
    default."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding, dilation, groups)
    return out.permute(0, 2, 3, 1)


def trunk_conv(conv: nn.Conv2d, h: torch.Tensor, slope: "float | None" = None,
               residual: "torch.Tensor | None" = None, scale: float = 1.0,
               outer: "torch.Tensor | None" = None, outer_scale: float = 1.0,
               dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """``conv`` on NHWC ``h`` in ``dtype`` (the conv's own by default; input,
    kernel and bias cast to it), then ``leaky_relu(., slope)``, ``residual +
    scale * .`` and ``outer + outer_scale * .`` (each only where given),
    fused into the one epilogue kernel in bf16 inference on a card."""
    dtype = dtype or conv.weight.dtype
    h = h.to(dtype)
    weight, bias = conv.weight.to(dtype), conv.bias.to(dtype)
    geometry = (conv.stride, conv.padding, conv.dilation, conv.groups)
    if h.is_cuda and dtype == torch.bfloat16 and not torch.is_grad_enabled():
        NETS["epilogue.fused"] += 1
        y = nhwc_conv(h, weight, None, *geometry).contiguous()
        return conv_epilogue_cuda(y, bias, slope, residual, scale, outer, outer_scale)
    NETS["epilogue.plain"] += 1
    return epilogue_rest(nhwc_conv(h, weight, bias, *geometry), slope, residual, scale, outer,
                         outer_scale)


def float32_tail(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 plain) -> torch.Tensor:
    """The float32 tail (3 output channels) on ``x``: the ``tail_conv``
    kernel on a bf16 CUDA tensor with autograd off, else ``plain()``."""
    with span(TAIL_SPAN):
        if (x.is_cuda and x.dtype == torch.bfloat16 and weight.shape[0] == 3
                and not torch.is_grad_enabled()):
            NETS["tail.fused"] += 1
            return tail_conv_cuda(x, weight, bias)
        NETS["tail.plain"] += 1
        return plain()
