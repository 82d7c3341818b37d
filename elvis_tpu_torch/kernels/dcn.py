"""The modulated deformable 3x3 convolution (DCNv2, arXiv:1811.11168) of
E2FGVI's feature propagation, in mmcv's ``modulated_deform_conv2d``
convention: stride 1, padding 1, dilation 1, one weight group.

Layouts are channels last: ``x`` ``(N, H, W, C)``; ``offset`` ``(N, H, W,
2 * G * 9)`` with deform group ``g``'s tap ``k`` (``k = 3 * ky + kx``) at
channels ``18 g + 2 k`` (row offset) and ``18 g + 2 k + 1`` (column
offset); ``mask`` ``(N, H, W, G * 9)`` with it at ``9 g + k``. Input
channel ``c`` belongs to deform group ``c // (C / G)``. Tap ``k`` of output
pixel ``(y, x)`` samples ``(y - 1 + ky + dy, x - 1 + kx + dx)`` bilinearly,
with zero padding outside the frame (nothing at all beyond one pixel of
it), and scales the sample by the mask.

  * ``deform_columns`` — the plain PyTorch version of the sampling: the
    column buffer ``(N, H, W, G * 9 * C / G)`` in ``x``'s dtype, column
    ``(g, k, c)`` at ``(9 g + k) * C / G + c``. Positions, bilinear weights
    and the weighted sum are float32, in one fixed order (``((w1 v1 + w2
    v2) + w3 v3) + w4 v4``, then times the mask), rounded once to ``x``'s
    dtype;
  * ``deform_columns_cuda`` — the hand-written CUDA kernel
    ``csrc/dcn.cu``: the same columns from a bf16 ``x``, bit-equal to the
    plain version on the card (every float32 step rounded as written, no
    contraction into fused multiply-adds). CUDA tensors only;
  * ``pack_weight`` — an OIHW weight ``(Co, C, 3, 3)`` as the GEMM's
    ``(G * 9 * C / G, Co)`` in the columns' order;
  * ``modulated_deform_conv`` — the whole convolution: the columns, then one
    GEMM against the packed weight with the bias (``torch.addmm``). On a
    CUDA tensor the kernel builds the columns, a frame chunk at a time so
    the buffer stays under ``COLUMN_BUDGET_BYTES``, or raises; the plain
    version serves every other device.

``LAUNCHES["dcn"]`` counts the kernel's launches (the ``launches`` family
of the port's counter registry, ``elvis_tpu_torch.utils.trace``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from elvis_tpu_torch.utils.trace import counter

__all__ = ["deform_columns", "deform_columns_cuda", "pack_weight", "modulated_deform_conv"]

LAUNCHES = counter("launches")
TAPS = 9
COLUMN_BUDGET_BYTES = 1 << 30
_VEC = 8  # bf16 channels in one 16-byte access: a group's channels come in such vectors

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _check(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} deform groups")
    if tuple(offset.shape) != (n, h, w, 2 * TAPS * groups):
        raise ValueError(f"offset must be {(n, h, w, 2 * TAPS * groups)}, got "
                         f"{tuple(offset.shape)}")
    if tuple(mask.shape) != (n, h, w, TAPS * groups):
        raise ValueError(f"mask must be {(n, h, w, TAPS * groups)}, got {tuple(mask.shape)}")


def deform_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """Plain version: ``x`` ``(N, H, W, C)`` any float dtype, ``offset`` and
    ``mask`` float (taken as float32). Returns the columns in ``x.dtype``."""
    _check(x, offset, mask, groups)
    n, h, w, c = x.shape
    cg = c // groups
    dev = x.device
    off = offset.float().reshape(n, h, w, groups, TAPS, 2)
    m = mask.float().reshape(n, h, w, groups, TAPS)
    tap = torch.arange(TAPS, device=dev)
    rows = (torch.arange(h, device=dev)[:, None] - 1 + tap // 3).float()  # (H, 9)
    cols = (torch.arange(w, device=dev)[:, None] - 1 + tap % 3).float()  # (W, 9)
    py = rows[None, :, None, None, :] + off[..., 0]  # (N, H, W, G, 9)
    px = cols[None, None, :, None, :] + off[..., 1]
    inside = (py > -1) & (px > -1) & (py < h) & (px < w)
    fy, fx = torch.floor(py), torch.floor(px)
    ly, lx = py - fy, px - fx
    hy, hx = 1 - ly, 1 - lx
    y0, x0 = fy.long(), fx.long()
    # (N, G, H*W, cg): a group's channels of every pixel, gathered per tap
    src = x.float().reshape(n, h * w, groups, cg).permute(0, 2, 1, 3)

    def corner(yy, xx):
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).permute(0, 3, 1, 2, 4)
        got = torch.gather(src, 2, idx.reshape(n, groups, -1, 1).expand(-1, -1, -1, cg))
        got = got.reshape(n, groups, h, w, TAPS, cg).permute(0, 2, 3, 1, 4, 5)
        return torch.where(ok[..., None], got, torch.zeros((), device=dev))

    v1, v2 = corner(y0, x0), corner(y0, x0 + 1)
    v3, v4 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    w1, w2, w3, w4 = (t[..., None] for t in (hy * hx, hy * lx, ly * hx, ly * lx))
    val = w1 * v1 + w2 * v2 + w3 * v3 + w4 * v4
    val = torch.where(inside[..., None], val, torch.zeros((), device=dev))
    return (val * m[..., None]).reshape(n, h, w, groups * TAPS * cg).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point ``elvis_dcn_columns`` of ``csrc/dcn.cu``."""
    from elvis_tpu_torch.kernels import _build

    fn = _build.load("dcn").elvis_dcn_columns
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def deform_columns_cuda(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """The kernel: ``x`` bf16 ``(N, H, W, C)``, ``offset`` and ``mask``
    float32, all contiguous on one CUDA device, ``x`` 16-byte aligned, a
    group's ``C / groups`` channels a multiple of 8. Returns the bf16
    columns.
    Raises ``TypeError`` for another dtype, ``ValueError`` for another
    shape or a tensor off the card, ``RuntimeError`` if the launch fails."""
    _check(x, offset, mask, groups)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the dcn kernel samples bf16 features, got {x.dtype}")
    if offset.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"the offsets and the mask must be float32, got {offset.dtype} and "
                        f"{mask.dtype}")
    if not all(t.is_cuda for t in (x, offset, mask)):
        raise ValueError("the dcn kernel takes CUDA tensors only")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError("x, the offsets and the mask must lie on one device")
    if not all(t.is_contiguous() for t in (x, offset, mask)):
        raise ValueError("x, the offsets and the mask must be contiguous (channels last)")
    n, h, w, c = x.shape
    cg = c // groups
    if cg % _VEC:
        raise ValueError(f"the dcn kernel takes a multiple of {_VEC} channels a group, got {cg}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = torch.empty((n, h, w, groups * TAPS * cg), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    index = x.device.index
    with torch.cuda.device(index):
        # the current stream's raw handle (a private call): the public
        # ``current_stream(...).cuda_stream`` builds a Stream object a call
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), out.data_ptr(), n, h, w, c,
                 groups, stream)
    if err != 0:
        raise RuntimeError(f"dcn kernel launch failed: CUDA error {err} (x {tuple(x.shape)}, "
                           f"{groups} groups)")
    LAUNCHES["dcn"] += 1
    return out


def pack_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """``(Co, C, 3, 3)`` -> ``(G * 9 * C / G, Co)``: row ``(9 g + k) * C / G
    + c`` holds ``weight[:, g * C / G + c, k // 3, k % 3]``."""
    co, c = weight.shape[:2]
    cg = c // groups
    return weight.reshape(co, groups, cg, TAPS).permute(1, 3, 2, 0).reshape(c * TAPS, co)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, groups: int) -> torch.Tensor:
    """``x`` ``(N, H, W, C)``, ``weight`` ``(Co, C, 3, 3)`` and ``bias``
    ``(Co,)`` in ``x``'s dtype -> ``(N, H, W, Co)`` in it. On a CUDA
    tensor the kernel samples (bf16 only); elsewhere the plain version."""
    n, h, w, c = x.shape
    co = weight.shape[0]
    packed = pack_weight(weight, groups)
    if not x.is_cuda:
        cols = deform_columns(x, offset, mask, groups)
        return torch.addmm(bias, cols.reshape(-1, c * TAPS), packed).reshape(n, h, w, co)
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    chunk = max(1, COLUMN_BUDGET_BYTES // max(1, h * w * c * TAPS * x.element_size()))
    for i in range(0, n, chunk):
        j = min(n, i + chunk)
        cols = deform_columns_cuda(x[i:j], offset[i:j], mask[i:j], groups)
        torch.addmm(bias, cols.reshape(-1, c * TAPS), packed, out=out[i:j].reshape(-1, co))
    return out
