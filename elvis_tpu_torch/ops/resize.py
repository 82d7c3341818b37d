"""Image resizing as separable sampling-matrix multiplies (port of
``elvis_tpu.ops.resize``).

``out = A_h @ img @ A_w^T`` where ``A`` encodes the interpolation taps
(OpenCV conventions: ``src = (dst + 0.5) * scale - 0.5`` for point-sampling
filters, exact box overlap for area downscale). The matrices are built on
the host in float64 exactly as the JAX package builds them; the dense path
runs in float32 with TF32 off, the counterpart of JAX's ``HIGHEST``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elvis_tpu_torch.device import full_fp32

__all__ = [
    "resize",
    "resize_matrix",
    "upsample2x_phases",
    "interleave_phases",
    "deinterleave_phases",
]


def _area_matrix(dst: int, src: int) -> np.ndarray:
    """Exact box-filter (cv2 INTER_AREA) weights for downscaling."""
    scale = src / dst
    mat = np.zeros((dst, src), dtype=np.float64)
    for d in range(dst):
        lo, hi = d * scale, (d + 1) * scale
        i0, i1 = int(np.floor(lo)), int(np.ceil(hi))
        for s in range(i0, min(i1, src)):
            overlap = min(hi, s + 1) - max(lo, s)
            if overlap > 0:
                mat[d, s] = overlap / scale
    return mat


def _tap_matrix(dst: int, src: int, support: float, kernel_fn) -> np.ndarray:
    """Point-sampled separable filter with clamp-to-edge padding."""
    scale = src / dst
    mat = np.zeros((dst, src), dtype=np.float64)
    centers = (np.arange(dst) + 0.5) * scale - 0.5
    for d, c in enumerate(centers):
        i0 = int(np.floor(c - support + 1))
        i1 = int(np.floor(c + support)) + 1
        taps = np.arange(i0, i1)
        w = kernel_fn(taps - c)
        wsum = w.sum()
        if wsum != 0:
            w = w / wsum
        idx = np.clip(taps, 0, src - 1)
        for t, ww in zip(idx, w):
            mat[d, t] += ww
    return mat


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos_kernel(a: int):
    def k(x: np.ndarray) -> np.ndarray:
        x = np.abs(x)
        out = np.where(x < 1e-9, 1.0, np.sinc(x) * np.sinc(x / a))
        return np.where(x >= a, 0.0, out)

    return k


def _nearest_matrix(dst: int, src: int) -> np.ndarray:
    scale = src / dst
    mat = np.zeros((dst, src), dtype=np.float64)
    idx = np.minimum((np.arange(dst) * scale).astype(np.int64), src - 1)
    mat[np.arange(dst), idx] = 1.0
    return mat


@functools.lru_cache(maxsize=512)
def resize_matrix(dst: int, src: int, method: str) -> np.ndarray:
    """Build (and cache) the ``(dst, src)`` 1-D resampling matrix."""
    if dst == src:
        return np.eye(dst)
    if method == "nearest":
        return _nearest_matrix(dst, src)
    if method == "area":
        if dst < src:
            return _area_matrix(dst, src)
        method = "linear"  # cv2 INTER_AREA degenerates to bilinear on upscale
    if method == "linear":
        return _tap_matrix(dst, src, 1.0, _linear_kernel)
    if method == "lanczos4":
        return _tap_matrix(dst, src, 4.0, _lanczos_kernel(4))
    raise ValueError(f"unknown resize method {method!r}")


@functools.lru_cache(maxsize=8)
def _phase_weights_2x(method: str):
    """Interior tap weights for an exact 2x upscale, one row per output
    phase: out[2i+p] = sum_k w[p][k] * in_padded[i + k + off[p]] — the same
    kernel and normalization as ``_tap_matrix``."""
    kernel = _linear_kernel if method == "linear" else _lanczos_kernel(4)
    support = 1.0 if method == "linear" else 4.0
    out = []
    for phase in (0, 1):
        c = 0.5 * phase - 0.25
        i0 = int(np.floor(c - support + 1))
        i1 = int(np.floor(c + support)) + 1
        taps = np.arange(i0, i1)
        w = kernel((taps - c).astype(np.float64))
        out.append((i0, [float(v) for v in (w / w.sum()).astype(np.float32)]))
    return out


_UP2X_PAD = 4  # covers lanczos4's reach (support 4); linear uses 1 of it


class _EdgePad(torch.autograd.Function):
    """``_UP2X_PAD`` copies of the edge row (or column) on each side of
    ``axis``: the edge slices concatenated around ``x``, not a gather of
    clamped indices. A gather's backward is ``index_add_``, which on a card
    adds the repeated edge rows with atomics in whatever order they arrive;
    this backward adds them in index order (the order ``index_add_`` takes
    on the CPU), so a step repeats bit for bit and the CPU's gradients are
    the gather's."""

    @staticmethod
    def forward(ctx, x, axis):
        n = x.shape[axis]
        ctx.axis, ctx.n = axis, n
        first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
        return torch.cat([first] * _UP2X_PAD + [x] + [last] * _UP2X_PAD, dim=axis)

    @staticmethod
    def backward(ctx, grad):
        axis, n, pad = ctx.axis, ctx.n, _UP2X_PAD
        row = lambda k: grad.narrow(axis, k, 1)  # noqa: E731
        out = grad.narrow(axis, pad, n).clone()
        first = row(0)
        for k in range(1, pad + 1):  # the left copies, then the edge row itself
            first = first + row(k)
        if n > 1:
            out.narrow(axis, 0, 1).copy_(first)
        last = first if n == 1 else row(pad + n - 1)
        for k in range(pad + n, n + 2 * pad):  # the right copies
            last = last + row(k)
        out.narrow(axis, n - 1, 1).copy_(last)
        return out, None


def _edge_pad(x: torch.Tensor, axis: int) -> torch.Tensor:
    return _EdgePad.apply(x, axis)


def _taps(xp: torch.Tensor, axis: int, n: int, i0: int, wts) -> torch.Tensor:
    acc = None
    for k, wk in enumerate(wts):
        s = xp.narrow(axis, _UP2X_PAD + i0 + k, n)
        acc = s * wk if acc is None else acc + s * wk
    return acc


def _upsample2x_axis(x: torch.Tensor, axis: int, method: str) -> torch.Tensor:
    """Exact 2x upscale along ``axis`` as shifted multiply-adds."""
    n = x.shape[axis]
    xp = _edge_pad(x, axis)
    phases = [_taps(xp, axis, n, i0, w) for i0, w in _phase_weights_2x(method)]
    stacked = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return stacked.reshape(shape)


def upsample2x_phases(x: torch.Tensor, method: str = "lanczos4") -> torch.Tensor:
    """Exact 2x upscale in PHASE form: ``(..., H, W, C) -> (..., H, W, 2, 2, C)``
    where ``out[..., i, j, a, b, c]`` is the interleaved result's pixel
    ``(2i+a, 2j+b)``. Float32 in, float32 out."""
    nd = x.dim()
    h, w = x.shape[-3], x.shape[-2]
    pw = _phase_weights_2x(method)
    xp = _edge_pad(x, nd - 3)
    rows = [_taps(xp, nd - 3, h, i0, wts) for i0, wts in pw]  # 2 x (..., H, W, C)
    out_ab = []
    for r in rows:
        rp = _edge_pad(r, nd - 2)
        out_ab.append(torch.stack([_taps(rp, nd - 2, w, i0, wts) for i0, wts in pw],
                                  dim=-2))  # (..., H, W, 2, C)
    return torch.stack(out_ab, dim=-3)  # (..., H, W, 2, 2, C)


def interleave_phases(y: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, 2, 2, C) -> (..., 2H, 2W, C)``."""
    *lead, h, w, _, _, c = y.shape
    n = y.dim() - 5
    return y.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4).reshape(
        *lead, 2 * h, 2 * w, c)


def deinterleave_phases(x: torch.Tensor) -> torch.Tensor:
    """``(..., 2H, 2W, C) -> (..., H, W, 2, 2, C)`` (inverse of
    ``interleave_phases``)."""
    *lead, h2, w2, c = x.shape
    y = x.reshape(*lead, h2 // 2, 2, w2 // 2, 2, c)
    n = y.dim() - 5
    return y.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)


def _area_downsample_int(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Exact integer-factor box filter: reshape + mean."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, out_h, h // out_h, out_w, w // out_w, c)
    return y.mean(dim=(-4, -2))


def resize(images: torch.Tensor, out_hw: tuple, method: str = "linear", *,
           clip_uint8_range: bool = True, channels: "bool | None" = None) -> torch.Tensor:
    """Resize ``(..., H, W)`` or ``(..., H, W, C)`` images to ``out_hw``.

    Compute runs in float32; the result is cast back to the input dtype
    (rounded half-to-even and clipped for integer inputs). ``channels``
    states whether the trailing dim is a channel axis; ``None`` takes a
    trailing dim of 1/3/4 as one.
    """
    out_h, out_w = out_hw
    if channels is None:
        has_c = images.dim() >= 3 and images.shape[-1] in (1, 3, 4)
    else:
        has_c = bool(channels) and images.dim() >= 3
    in_hw = tuple(images.shape[-3:-1] if has_c else images.shape[-2:])
    orig_dtype = images.dtype
    is_int = not orig_dtype.is_floating_point
    if in_hw == (out_h, out_w) and not (clip_uint8_range and orig_dtype == torch.int8):
        return images
    x = images if has_c else images[..., None]
    h, w = x.shape[-3], x.shape[-2]
    xf = x.float()
    if method in ("linear", "lanczos4") and (out_h, out_w) == (2 * h, 2 * w):
        y = _upsample2x_axis(xf, x.dim() - 3, method)
        y = _upsample2x_axis(y, x.dim() - 2, method)
    elif (method == "area" and out_h <= h and out_w <= w
          and h % out_h == 0 and w % out_w == 0):
        y = _area_downsample_int(xf, out_h, out_w)
    else:
        ah = torch.as_tensor(resize_matrix(out_h, h, method), dtype=torch.float32,
                             device=x.device)
        aw = torch.as_tensor(resize_matrix(out_w, w, method), dtype=torch.float32,
                             device=x.device)
        with full_fp32():
            y = torch.einsum("oh,...hwc->...owc", ah, xf)
            y = torch.einsum("pw,...hwc->...hpc", aw, y)
    if not has_c:
        y = y[..., 0]
    if is_int:
        info = torch.iinfo(orig_dtype)
        lo, hi = (0, 255) if clip_uint8_range and info.bits == 8 else (info.min, info.max)
        y = torch.clamp(torch.round(y), lo, hi)
    return y.to(orig_dtype)
