"""Masked pixel metrics: PSNR / MSE / SSIM (port of ``elvis_tpu.metrics.pixel``).

  * ``masked_psnr`` — MSE over mask pixels (all channels), PSNR capped at
    100 dB, empty mask -> 100;
  * ``masked_mse`` — the same MSE, empty mask -> 0;
  * ``masked_ssim`` — SSIM on the luma channel of the mask's bounding-box
    crop with pixels outside the mask zeroed; Gaussian window sigma=1.5
    truncated to 7 taps, sample covariance (NP/(NP-1)), border crop of
    (win-1)//2, edge-replicate filter padding.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from elvis_tpu_torch.ops.color import rgb_to_ycbcr

__all__ = ["masked_psnr", "masked_mse", "masked_ssim", "ssim", "mask_union_bbox"]


def masked_mse(ref: torch.Tensor, dec: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N,H,W,C)`` pairs (+ optional ``(N,H,W)`` bool mask) -> (N,) MSE."""
    diff = (ref.float() - dec.float()) ** 2
    if mask is None:
        return diff.mean(dim=(1, 2, 3))
    m = mask.float()[..., None]
    num = (diff * m).sum(dim=(1, 2, 3))
    den = m.sum(dim=(1, 2, 3)) * ref.shape[-1]
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)


def masked_psnr(ref: torch.Tensor, dec: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) PSNR in dB, capped at 100."""
    mse = masked_mse(ref, dec, mask)
    psnr = 20.0 * torch.log10(255.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
    psnr = torch.where(mse < 1e-10, 100.0, torch.clamp(psnr, max=100.0))
    if mask is not None:
        empty = mask.float().sum(dim=(1, 2)) == 0
        psnr = torch.where(empty, 100.0, psnr)
    return psnr


@functools.lru_cache(maxsize=16)
def _ssim_window(win_size: int, sigma: float = 1.5) -> np.ndarray:
    """Gaussian taps matching scipy.ndimage.gaussian_filter1d truncated to
    win_size."""
    r = (win_size - 1) // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _edge_index(n: int, r: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(-r, n + r, device=device), 0, n - 1)


def _filter2d_nearest(img: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """Separable correlation of ``(N, H, W)`` with edge-replicate padding."""
    k = torch.as_tensor(kern, dtype=torch.float32, device=img.device)
    r = (kern.shape[0] - 1) // 2
    h, w = img.shape[1], img.shape[2]
    x = img.index_select(1, _edge_index(h, r, img.device))
    x = x.index_select(2, _edge_index(w, r, img.device))
    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for i in range(kern.shape[0]):
        out = out + k[i] * x[:, i : i + h, r : r + w]
    x2 = out.index_select(2, _edge_index(w, r, img.device))
    out2 = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for i in range(kern.shape[0]):
        out2 = out2 + k[i] * x2[:, :, i : i + w]
    return out2


def ssim(ref_y: torch.Tensor, dec_y: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7, *, crop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian-weighted SSIM over ``(N, H, W)`` luma pairs -> (N,).
    ``crop_mask`` (N,H,W bool) restricts the final mean."""
    kern = _ssim_window(win_size)
    x = ref_y.float()
    y = dec_y.float()
    ux = _filter2d_nearest(x, kern)
    uy = _filter2d_nearest(y, kern)
    uxx = _filter2d_nearest(x * x, kern)
    uyy = _filter2d_nearest(y * y, kern)
    uxy = _filter2d_nearest(x * y, kern)

    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))

    pad = (win_size - 1) // 2
    h, w = s.shape[1], s.shape[2]
    valid = torch.zeros((h, w), dtype=torch.bool, device=s.device)
    valid[pad : h - pad, pad : w - pad] = True
    if crop_mask is not None:
        valid = valid[None] & crop_mask
    else:
        valid = valid[None].expand(s.shape)
    vf = valid.float()
    return (s * vf).sum(dim=(1, 2)) / torch.clamp(vf.sum(dim=(1, 2)), min=1.0)


def mask_union_bbox(masks, padding_ratio: float = 0.05) -> Tuple[int, int, int, int]:
    """Padded bbox (x, y, w, h) over the union of ``(N,H,W)`` bool masks
    (host-side geometry)."""
    if isinstance(masks, torch.Tensor):
        masks = masks.cpu().numpy()
    masks = np.asarray(masks)
    height, width = masks.shape[-2], masks.shape[-1]
    union = masks.any(axis=0) if masks.ndim == 3 else masks
    if not union.any():
        return (0, 0, width, height)
    ys, xs = np.where(union)
    min_y, max_y = int(ys.min()), int(ys.max())
    min_x, max_x = int(xs.min()), int(xs.max())
    bh, bw = max_y - min_y + 1, max_x - min_x + 1
    pad_y = max(1, int(bh * padding_ratio))
    pad_x = max(1, int(bw * padding_ratio))
    y = max(0, min_y - pad_y)
    x = max(0, min_x - pad_x)
    h = min(height - y, bh + 2 * pad_y)
    w = min(width - x, bw + 2 * pad_x)
    return (x, y, w, h)


def masked_ssim(ref: torch.Tensor, dec: torch.Tensor, mask: Optional[torch.Tensor] = None,
                *, bbox: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """Luma SSIM of the masked bbox crop, outside-mask pixels zeroed, win 7
    (shrunk for tiny crops). Without a mask the SSIM runs full-frame."""
    ref_y = rgb_to_ycbcr(ref.float())[..., 0]
    dec_y = rgb_to_ycbcr(dec.float())[..., 0]
    if mask is None:
        return ssim(ref_y, dec_y)
    if bbox is None:
        bbox = mask_union_bbox(mask)
    x, y, w, h = bbox
    m = mask[:, y : y + h, x : x + w].bool()
    ref_c = torch.where(m, ref_y[:, y : y + h, x : x + w], 0.0)
    dec_c = torch.where(m, dec_y[:, y : y + h, x : x + w], 0.0)
    smallest = min(h, w)
    if smallest < 3:
        return torch.ones((ref.shape[0],), dtype=torch.float32, device=ref.device)
    win = 7 if smallest >= 7 else (smallest if smallest % 2 == 1 else max(3, smallest - 1))
    out = ssim(ref_c, dec_c, win_size=win)
    empty = mask.float().sum(dim=(1, 2)) == 0
    return torch.where(empty, 1.0, out)
