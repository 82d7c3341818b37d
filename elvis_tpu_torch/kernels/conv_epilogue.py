"""The epilogue of the SR nets' bf16 trunk convolutions: bias, leaky ReLU and
scaled residuals of one conv output.

  * ``conv_epilogue`` — the plain PyTorch version, on a conv output without
    its bias: ``bias`` added, then ``epilogue_rest``. The comparison target
    on the card;
  * ``epilogue_rest`` — the steps after the bias, as PyTorch ops in the
    models' order: ``leaky_relu(t, slope)``, ``residual + scale * t``,
    ``outer + outer_scale * t`` (each only where given);
  * ``conv_epilogue_cuda`` — the hand-written CUDA kernel
    ``csrc/conv_epilogue.cu``: all of it in one in-place pass over an
    ``(N, H, W, C)`` bf16 conv output, bit-equal to the plain version on the
    card (every step rounds to bf16 where PyTorch's elementwise kernels do).
    CUDA tensors only, C up to the kernel's ``kMaxChannels`` (2048).

``LAUNCHES["conv_epilogue"]`` counts the kernel's launches (the ``launches``
family of the port's counter registry, ``elvis_tpu_torch.utils.trace``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from elvis_tpu_torch.utils.trace import counter

__all__ = ["conv_epilogue", "conv_epilogue_cuda", "epilogue_rest"]

LAUNCHES = counter("launches")
_ALIGN = 16  # bytes of one vector access

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def epilogue_rest(t: torch.Tensor, slope: "float | None" = None,
                  residual: "torch.Tensor | None" = None, scale: float = 1.0,
                  outer: "torch.Tensor | None" = None, outer_scale: float = 1.0) -> torch.Tensor:
    """``t`` (a conv output with its bias) through the leaky ReLU and the
    residual sums, as PyTorch ops; a scale of 1 multiplies nothing."""
    if slope is not None:
        t = F.leaky_relu(t, slope)
    if residual is not None:
        t = residual + (t if scale == 1.0 else scale * t)
    if outer is not None:
        t = outer + (t if outer_scale == 1.0 else outer_scale * t)
    return t


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, slope: "float | None" = None,
                  residual: "torch.Tensor | None" = None, scale: float = 1.0,
                  outer: "torch.Tensor | None" = None, outer_scale: float = 1.0) -> torch.Tensor:
    """Plain version: ``y`` ``(..., C)`` without its bias, ``bias`` ``(C,)``.
    Returns a new tensor."""
    return epilogue_rest(y + bias, slope, residual, scale, outer, outer_scale)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point ``elvis_conv_epilogue`` of ``csrc/conv_epilogue.cu``."""
    from elvis_tpu_torch.kernels import _build

    fn = _build.load("conv_epilogue").elvis_conv_epilogue
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor, slope: "float | None" = None,
                       residual: "torch.Tensor | None" = None, scale: float = 1.0,
                       outer: "torch.Tensor | None" = None,
                       outer_scale: float = 1.0) -> torch.Tensor:
    """The kernel: ``y`` ``(N, H, W, C)`` bf16 (a conv output without its
    bias), ``bias`` ``(C,)`` bf16, ``residual`` and ``outer`` None or like
    ``y``, all contiguous on one CUDA device, y, residual and outer 16-byte
    aligned; ``outer`` only with ``residual``; C at most 2048 (the kernel
    refuses more: ``RuntimeError``). Writes the epilogue into ``y`` in one
    launch and returns it. The scalars are taken as float32."""
    operands = [t for t in (y, bias, residual, outer) if t is not None]
    if not all(t.is_cuda for t in operands):
        raise ValueError("the conv_epilogue kernel takes CUDA tensors only")
    if any(t.device != y.device for t in operands):
        raise ValueError("y, bias and the residuals must lie on one device")
    if any(t.dtype != torch.bfloat16 for t in operands):
        raise TypeError(f"the conv_epilogue kernel takes bf16 tensors, got "
                        f"{[t.dtype for t in operands]}")
    if y.dim() != 4:
        raise ValueError(f"y must be (N, H, W, C), got {tuple(y.shape)}")
    c = y.shape[-1]
    if tuple(bias.shape) != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    if outer is not None and residual is None:
        raise ValueError("an outer residual needs the inner one")
    for name, r in (("residual", residual), ("outer", outer)):
        if r is not None and r.shape != y.shape:
            raise ValueError(f"{name} must be {tuple(y.shape)}, got {tuple(r.shape)}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("y, bias and the residuals must be contiguous (channels last)")
    if any(t.data_ptr() % _ALIGN for t in (y, residual, outer) if t is not None):
        raise ValueError(f"y and the residuals must be {_ALIGN}-byte aligned")
    if y.numel() == 0:
        return y
    fn = _kernel_fn()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), bias.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 None if outer is None else outer.data_ptr(), y.numel(), c,
                 int(slope is not None), 0.0 if slope is None else slope, scale, outer_scale,
                 _sm_count(y.device.index), stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {err} "
                           f"(y {tuple(y.shape)})")
    LAUNCHES["conv_epilogue"] += 1
    return y
