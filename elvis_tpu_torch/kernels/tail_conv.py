"""The SR nets' float32 tail: a 3x3 SAME convolution from ``Cin`` channels to
3, with its bias, in float32, at full resolution. Two input geometries:

  * phase: ``(N, H, W, 2, 2, Cin) -> (N, H, W, 2, 2, 3)``, the pixel
    shuffle's input: full-resolution pixel ``(2i + a, 2j + b)`` is
    ``x[n, i, j, a, b]``, and zero padding applies at the full-resolution
    edge;
  * direct: ``(N, H, W, Cin) -> (N, H, W, 3)``.

  * ``tail_conv`` — the plain PyTorch version: the float32 convolution over
    the full-resolution image (TF32 off), the phase form interleaved before
    and after. The comparison target on the card;
  * ``tail_conv_cuda`` — the hand-written CUDA kernel ``csrc/tail_conv.cu``
    on a bf16 input, read where it lies: float32 products and sums of the
    9 real taps of each output pixel, in one fixed order (two calls are
    bit-equal). CUDA tensors only.

The kernel's weights are packed once per weight version (``pack_weight``;
cached per weight tensor on its ``data_ptr`` and ``_version``).
``LAUNCHES["tail_conv"]`` counts the kernel's launches (the ``launches``
family of the port's counter registry, ``elvis_tpu_torch.utils.trace``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.ops.resize import deinterleave_phases, interleave_phases
from elvis_tpu_torch.utils.trace import counter

__all__ = ["tail_conv", "tail_conv_cuda", "pack_weight"]

LAUNCHES = counter("launches")
COUT = 3
_CHUNK = 4  # the planar kernel's channel chunk: packed weights are padded to it

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]

# weight tensor -> ((data_ptr, _version), packed weights)
_PACKED = WeakIdKeyDictionary()


def _is_phase(x: torch.Tensor) -> bool:
    return x.dim() == 6


def tail_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x`` in either geometry, any float dtype (cast to
    float32), ``weight`` ``(Co, Cin, 3, 3)``, ``bias`` ``(Co,)``, both float32.
    Returns float32 in ``x``'s geometry."""
    phase = _is_phase(x)
    full = interleave_phases(x) if phase else x
    with full_fp32():
        out = F.conv2d(full.float().permute(0, 3, 1, 2), weight, None, padding=1)
    out = out.permute(0, 2, 3, 1) + bias
    return deinterleave_phases(out) if phase else out


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """``(3, Cin, 3, 3)`` float32 -> the kernel's ``(ceil(Cin / 4) * 4, 28)``:
    row ``c`` holds ``weight[o, c, ky, kx]`` at ``(ky * 3 + kx) * 3 + o``,
    then a zero; rows past ``Cin`` are zero."""
    cin = weight.shape[1]
    pad = -cin % _CHUNK
    with torch.no_grad():
        taps = weight.permute(1, 2, 3, 0).reshape(cin, 9 * COUT)
        return F.pad(taps, (0, 1, 0, pad)).contiguous()


def _packed(weight: torch.Tensor) -> torch.Tensor:
    """``pack_weight(weight)``, reused while the tensor keeps its storage and
    version; an inference tensor keeps no version and is packed each call."""
    if weight.is_inference():
        return pack_weight(weight)
    key = (weight.data_ptr(), weight._version)
    hit = _PACKED.get(weight)
    if hit is None or hit[0] != key:
        hit = (key, pack_weight(weight))
        _PACKED[weight] = hit
    return hit[1]


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point ``elvis_tail_conv`` of ``csrc/tail_conv.cu``."""
    from elvis_tpu_torch.kernels import _build

    fn = _build.load("tail_conv").elvis_tail_conv
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tail_conv_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel: ``x`` bf16, contiguous, ``(N, H, W, Cin)`` (direct) or
    ``(N, H, W, 2, 2, Cin)`` (phase); ``weight`` ``(3, Cin, 3, 3)`` and
    ``bias`` ``(3,)`` float32; all on one CUDA device. Returns a new float32
    tensor ``x.shape[:-1] + (3,)``. Raises ``TypeError`` for another dtype,
    ``ValueError`` for another shape, a non-contiguous ``x``, other than 3
    output channels or a tensor off the card, ``RuntimeError`` if the launch
    fails."""
    if not (x.dim() == 4 or (x.dim() == 6 and tuple(x.shape[3:5]) == (2, 2))):
        raise ValueError(f"x must be (N, H, W, Cin) or (N, H, W, 2, 2, Cin), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the tail_conv kernel reads a bf16 input, got {x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"the tail's weight and bias must be float32, got {weight.dtype} "
                        f"and {bias.dtype}")
    cin = x.shape[-1]
    if weight.dim() != 4 or weight.shape[0] != COUT:
        raise ValueError(f"the tail_conv kernel has {COUT} output channels, got a weight of "
                         f"{tuple(weight.shape)}")
    if tuple(weight.shape) != (COUT, cin, 3, 3) or tuple(bias.shape) != (COUT,):
        raise ValueError(f"weight must be ({COUT}, {cin}, 3, 3) and bias ({COUT},), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if not x.is_contiguous() or not bias.is_contiguous():
        raise ValueError("x and the bias must be contiguous (channels last)")
    if not all(t.is_cuda for t in (x, weight, bias)):
        raise ValueError("the tail_conv kernel takes CUDA tensors only")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, the weight and the bias must lie on one device")
    out = torch.empty(x.shape[:-1] + (COUT,), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    phase = _is_phase(x)
    n, hf, wf = x.shape[0], x.shape[1] * (2 if phase else 1), x.shape[2] * (2 if phase else 1)
    packed = _packed(weight)
    fn = _kernel_fn()
    index = x.device.index
    with torch.cuda.device(index):
        # the current stream's raw handle (a private call): the public
        # ``current_stream(...).cuda_stream`` builds a Stream object a call
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = fn(x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(), n, hf, wf,
                 cin, int(phase), _sm_count(index), stream)
    if err != 0:
        raise RuntimeError(f"tail_conv kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)})")
    LAUNCHES["tail_conv"] += 1
    return out
