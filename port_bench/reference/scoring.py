"""Plain reference of ELVIS's server side before the codec: removability
scores, downsample levels and the per-block degrade.

Scores (per 8x8 block, for a segment of RGB frames):
- luma ``0.299 R + 0.587 G + 0.114 B``; a block's texture energy is the
  sum of its orthonormal 2-D DCT's magnitudes weighted by
  ``sqrt(u^2 + v^2) / max`` (DC weight 0), over ``b^2``; SC of each frame,
  TC of each frame's difference from the previous (0 on the first);
- motion-contrast saliency: colour distance from the frame's mean colour,
  normalised per frame, times ``0.5 + 0.5 *`` the normalised motion energy
  (mean of the backward and forward absolute luma differences, one-sided
  at the ends), times the square root of a centred Gaussian (sigma a
  quarter of the short side), blurred by a 5-tap Gaussian of sigma 2 with
  mirrored borders (the edge sample not repeated), normalised per frame;
  a block is foreground where its mean is at least 0.5;
- SC and TC each normalised over the segment;
  ``alpha SC[t] + (1 - alpha) TC[t + 1]`` (``SC`` on the last frame), times
  10 off the foreground, smoothed over time by ``beta``, normalised.

Levels ``round(3 * score)`` (half to even). Degrade: each block ``X`` of
level ``l`` becomes ``T_l X T_l^T`` with ``T_l`` the 8 -> ``8 / 2^l`` box
average followed by the linear upsample back (sample ``(d + 0.5) s - 0.5``,
two taps, edges repeated), rounded half to even to uint8.

Everything in float32 with TF32 off; ``tf32=True`` is the control: every
product's inputs rounded to TF32's 10-bit mantissa (``to_tf32``), the step
below the configuration's full float32, on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference.precision import to_tf32

B = 8


def dct(device) -> torch.Tensor:
    """The orthonormal 8x8 DCT-II matrix ``D[k, i]``, float32."""
    k = np.arange(B)[:, None]
    i = np.arange(B)[None, :]
    d = np.cos(np.pi / B * (i + 0.5) * k) * np.sqrt(2.0 / B)
    d[0] /= np.sqrt(2.0)
    return torch.as_tensor(d, dtype=torch.float32, device=device)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` -> ``(N, By, Bx, 8, 8)``."""
    n, h, w = x.shape
    return x.reshape(n, h // B, B, w // B, B).permute(0, 1, 3, 2, 4)


def texture_energy(gray: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    rnd = to_tf32 if tf32 else (lambda t: t)
    d = rnd(dct(gray.device))
    c = torch.einsum("lc,nyxkc->nyxkl", d,
                     rnd(torch.einsum("kb,nyxbc->nyxkc", d, rnd(_blocks(gray)))))
    u = np.arange(B, dtype=np.float64)
    wt = np.sqrt(u[:, None] ** 2 + u[None, :] ** 2)
    wt[0, 0] = 0.0
    wt = torch.as_tensor(wt / wt.max(), dtype=torch.float32, device=gray.device)
    return (c.abs() * wt).sum(dim=(-2, -1)) / (B * B)


def _norm(x: torch.Tensor, dims=None) -> torch.Tensor:
    if dims is None:
        lo, hi = x.min(), x.max()
    else:
        lo, hi = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    return (x - lo) / (hi - lo + 1e-8)


def _mirror(n: int, pad: int) -> torch.Tensor:
    idx = []
    for i in range(-pad, n + pad):
        while i < 0 or i >= n:
            i = -i if i < 0 else 2 * (n - 1) - i
        idx.append(i)
    return torch.tensor(idx)


def _blur(x: torch.Tensor, sigma: float = 2.0, taps: int = 5) -> torch.Tensor:
    """Separable Gaussian over the last two axes of ``(N, H, W)``, rows
    first, mirrored borders."""
    half = (taps - 1) // 2
    k = np.exp(-((np.arange(taps) - half) ** 2) / (2.0 * sigma**2))
    k = torch.as_tensor(k / k.sum(), dtype=torch.float32, device=x.device)
    for axis in (1, 2):
        n = x.shape[axis]
        xp = x.index_select(axis, _mirror(n, half).to(x.device))
        acc = torch.zeros_like(x)
        for i in range(taps):
            acc = acc + k[i] * xp.narrow(axis, i, n)
        x = acc
    return x


def saliency(frames: torch.Tensor) -> torch.Tensor:
    x = frames.float()
    n, h, w, _ = x.shape
    contrast = torch.sqrt(((x - x.mean(dim=(1, 2), keepdim=True)) ** 2).sum(dim=-1))
    gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    d = (gray[1:] - gray[:-1]).abs()
    motion = torch.cat([d[:1], 0.5 * (d[:-1] + d[1:]), d[-1:]]) if n > 2 else torch.cat([d, d])
    sal = _norm(contrast, (1, 2)) * (0.5 + 0.5 * _norm(motion, (1, 2)))
    r = min(h, w) / 2.0
    yy = (torch.arange(h, device=x.device) - (h - 1) / 2.0) / r
    xx = (torch.arange(w, device=x.device) - (w - 1) / 2.0) / r
    bump = torch.exp(-(yy[:, None] ** 2 + xx[None, :] ** 2) / 0.5)
    sal = sal * (bump / bump.max()) ** 0.5
    return _norm(_blur(sal), (1, 2))


def scores(frames: torch.Tensor, alpha: float = 0.5, beta: float = 0.5,
           tf32: bool = False) -> torch.Tensor:
    """uint8 ``(N, H, W, 3)`` -> removability ``(N, By, Bx)`` in [0, 1]."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = frames.float()
        gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        sc = texture_energy(gray, tf32)
        tc = torch.cat([torch.zeros_like(sc[:1]), texture_energy(gray[1:] - gray[:-1], tf32)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    sal = saliency(frames)
    n, h, w = sal.shape
    fg = sal.reshape(n, h // B, B, w // B, B).mean(dim=(2, 4)) >= 0.5
    sc, tc = _norm(sc), _norm(tc)
    s = torch.cat([alpha * sc[:-1] + (1 - alpha) * tc[1:], sc[-1:]])
    s = torch.where(fg, s, s * 10.0)
    s = torch.cat([s[:1], beta * s[1:] + (1 - beta) * s[:-1]])
    return _norm(s)


def levels_of(scores_: torch.Tensor) -> torch.Tensor:
    return torch.round(scores_ * 3).to(torch.int32)


def _linear_up(dst: int, src: int) -> np.ndarray:
    mat = np.zeros((dst, src))
    for d in range(dst):
        c = (d + 0.5) * src / dst - 0.5
        i0 = math.floor(c)
        for i in (i0, i0 + 1):
            wgt = max(0.0, 1.0 - abs(i - c))
            mat[d, min(max(i, 0), src - 1)] += wgt
        mat[d] /= mat[d].sum()
    return mat


def level_table(max_level: int) -> np.ndarray:
    out = [np.eye(B)]
    for lvl in range(1, max_level + 1):
        s = B // 2**lvl
        down = np.kron(np.eye(s), np.full((1, 2**lvl), 1.0 / 2**lvl))
        out.append(_linear_up(B, s) @ down)
    return np.stack(out)


def degrade(frames: torch.Tensor, levels: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """uint8 ``(N, H, W, 3)``, int ``(N, By, Bx)`` -> uint8."""
    n, h, w, c = frames.shape
    rnd = to_tf32 if tf32 else (lambda a: a)
    t = torch.as_tensor(level_table(3), dtype=torch.float32, device=frames.device)[levels.long()]
    t = rnd(t)[:, :, :, None]
    x = frames.float().reshape(n, h // B, B, w // B, B, c).permute(0, 1, 3, 5, 2, 4)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = rnd(t @ rnd(x)) @ t.transpose(-2, -1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, h, w, c)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
