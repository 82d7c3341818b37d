"""E2FGVI-HQ's feed-forward between its two linears (``FusionFeedForward``
of ``tfocal_transformer_hq.py``): fc1's output, ``(T, th * tw, C * 49)``
tokens of ``C`` channels of 7x7 patches (value ``(c, ki, kj)`` at ``c * 49
+ ki * 7 + kj``, fold's own convention), folded onto a ``C x H x W`` map
(stride 3, padding 3), divided by the fold of ones, unfolded again, GELU,
in fc1's dtype: what fc2 reads.

  * ``ffn_fold_gelu`` — the plain PyTorch version: ``F.fold`` in float32 over
    the tokens' transposed view, the fold of ones, ``F.unfold``, ``F.gelu``,
    the cast back; a ``(T, th * tw, C * 49)`` view of the unfolded map. The
    comparison target on the card;
  * ``ffn_fold_gelu_cuda`` — the hand-written CUDA kernel
    ``csrc/ffn_fold.cu`` on a contiguous bf16 input: the same float32 sums in
    col2im's order, the same division and GELU, rounded once to bf16, so
    bit-equal to the plain version on the card; one pass, writing a new
    contiguous tensor. CUDA tensors only.

``LAUNCHES["ffn_fold"]`` counts the kernel's launches (the ``launches``
family of the port's counter registry, ``elvis_tpu_torch.utils.trace``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from elvis_tpu_torch.utils.trace import counter

__all__ = ["ffn_fold_gelu", "ffn_fold_gelu_cuda", "token_grid"]

LAUNCHES = counter("launches")
PATCH, STRIDE, PAD = 7, 3, 3
TAPS = PATCH * PATCH
_GROUP = 8  # channels a CTA of the kernel: 8 x 49 bf16 are 49 16-byte vectors
_ROWS = 30  # the most token rows a CTA of the kernel writes (a third of the cell's 90)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def token_grid(output_size: tuple) -> tuple:
    """The ``(th, tw)`` tokens of 7x7 patches at stride 3, padding 3 over an
    ``output_size`` map."""
    return tuple((s + 2 * PAD - PATCH) // STRIDE + 1 for s in output_size)


def _check(h: torch.Tensor, th: int, tw: int, output_size: tuple) -> None:
    if h.dim() != 3 or h.shape[1] != th * tw or h.shape[2] % TAPS:
        raise ValueError(f"h must be (T, {th} * {tw}, C * {TAPS}), got {tuple(h.shape)}")
    if token_grid(output_size) != (th, tw):
        raise ValueError(f"{th}x{tw} tokens do not tile a {tuple(output_size)} map")


def ffn_fold_gelu(h: torch.Tensor, th: int, tw: int, output_size: tuple) -> torch.Tensor:
    """Plain version: ``h`` ``(T, th * tw, C * 49)`` any float dtype ->
    ``gelu(unfold(fold(h) / fold(1)))`` in ``h``'s dtype, the fold, its
    division and GELU in float32."""
    _check(h, th, tw, output_size)
    fold = dict(output_size=output_size, kernel_size=PATCH, padding=PAD, stride=STRIDE)
    ones = torch.ones((1, TAPS, th * tw), dtype=torch.float32, device=h.device)
    x = F.fold(h.float().transpose(1, 2), **fold) / F.fold(ones, **fold)
    x = F.unfold(x, kernel_size=PATCH, padding=PAD, stride=STRIDE).transpose(1, 2)
    return F.gelu(x).to(h.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point ``elvis_ffn_fold_gelu`` of ``csrc/ffn_fold.cu``."""
    from elvis_tpu_torch.kernels import _build

    fn = _build.load("ffn_fold").elvis_ffn_fold_gelu
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ffn_fold_gelu_cuda(h: torch.Tensor, th: int, tw: int, output_size: tuple) -> torch.Tensor:
    """The kernel: ``h`` bf16, contiguous ``(T, th * tw, C * 49)`` on a CUDA
    device, ``C`` a multiple of 8, 16-byte aligned. Returns a new contiguous
    bf16 tensor of its shape, bit-equal to ``ffn_fold_gelu(h, ...)`` there.
    Raises ``TypeError`` for another dtype,
    ``ValueError`` for another shape, a non-contiguous or misaligned input
    or a tensor off the card, ``RuntimeError`` if the launch fails."""
    _check(h, th, tw, output_size)
    if h.dtype != torch.bfloat16:
        raise TypeError(f"the ffn_fold kernel reads fc1's bf16 output, got {h.dtype}")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous, as the linear leaves it")
    if not h.is_cuda:
        raise ValueError("the ffn_fold kernel takes CUDA tensors only")
    channels = h.shape[2] // TAPS
    if channels % _GROUP:
        raise ValueError(f"the ffn_fold kernel takes a multiple of {_GROUP} channels, got "
                         f"{channels}")
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned")
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    chunk = -(-th // -(-th // _ROWS))  # the rows split evenly, at most _ROWS a CTA
    fn = _kernel_fn()
    index = h.device.index
    with torch.cuda.device(index):
        # the current stream's raw handle (a private call): the public
        # ``current_stream(...).cuda_stream`` builds a Stream object a call
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = fn(h.data_ptr(), out.data_ptr(), h.shape[0], th, tw, output_size[0],
                 output_size[1], channels, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ffn_fold kernel launch failed: CUDA error {err} (h "
                           f"{tuple(h.shape)}, {th}x{tw} tokens, map {tuple(output_size)})")
    LAUNCHES["ffn_fold"] += 1
    return out
