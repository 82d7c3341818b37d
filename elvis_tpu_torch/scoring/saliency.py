"""Foreground saliency slot (port of ``elvis_tpu.scoring.saliency``).

A saliency function maps ``frames (N, H, W, C)`` -> ``mask (N, H, W)``
float in [0, 1] (>= 0.5 means foreground), registered by name: the
heuristics ``center_prior`` and ``motion_contrast``, and ``neural``, the
shipped SaliencyNet (``models.saliency_net``). The function
``get_saliency_fn`` returns records the span ``score.saliency`` under
``torch.profiler``, whichever backend it is.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from elvis_tpu_torch.core.blocks import blockwise_reduce
from elvis_tpu_torch.ops.color import rgb_to_gray
from elvis_tpu_torch.ops.filter import gaussian_blur
from elvis_tpu_torch.utils.trace import span

__all__ = [
    "register_saliency",
    "get_saliency_fn",
    "center_prior_saliency",
    "motion_contrast_saliency",
    "neural_saliency",
    "saliency_to_block_mask",
]

SaliencyFn = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, SaliencyFn] = {}


def register_saliency(name: str):
    def deco(fn: SaliencyFn) -> SaliencyFn:
        @functools.wraps(fn)
        def spanned(frames: torch.Tensor) -> torch.Tensor:
            with span("score.saliency"):
                return fn(frames)

        _REGISTRY[name] = spanned
        return fn

    return deco


def get_saliency_fn(name: str) -> SaliencyFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown saliency backend {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


@register_saliency("center_prior")
def center_prior_saliency(frames: torch.Tensor) -> torch.Tensor:
    """Isotropic Gaussian bump centred on the frame, sigma = 1/4 of the
    short side."""
    n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    dev = frames.device
    yy = (torch.arange(h, device=dev) - (h - 1) / 2.0) / (min(h, w) / 2.0)
    xx = (torch.arange(w, device=dev) - (w - 1) / 2.0) / (min(h, w) / 2.0)
    r2 = yy[:, None] ** 2 + xx[None, :] ** 2
    bump = torch.exp(-r2 / (2 * 0.5**2))
    return (bump / bump.max()).expand(n, h, w)


def _norm01(a: torch.Tensor) -> torch.Tensor:
    lo = a.amin(dim=(1, 2), keepdim=True)
    hi = a.amax(dim=(1, 2), keepdim=True)
    return (a - lo) / (hi - lo + 1e-8)


@register_saliency("motion_contrast")
def motion_contrast_saliency(frames: torch.Tensor) -> torch.Tensor:
    """Temporal motion energy x colour contrast vs the frame's mean colour,
    centre-weighted, blurred, normalized per frame."""
    x = frames.float()
    n = x.shape[0]
    mean_color = x.mean(dim=(1, 2), keepdim=True)
    contrast = torch.sqrt(((x - mean_color) ** 2).sum(dim=-1))  # (N,H,W)

    gray = rgb_to_gray(x)
    d_fwd = torch.abs(torch.diff(gray, dim=0))
    if n > 2:
        motion = torch.cat([d_fwd[:1], (d_fwd[:-1] + d_fwd[1:]) / 2.0, d_fwd[-1:]], dim=0)
    elif n == 2:
        motion = torch.cat([d_fwd, d_fwd], dim=0)
    else:
        motion = torch.zeros_like(gray)

    sal = _norm01(contrast) * (0.5 + 0.5 * _norm01(motion))
    sal = sal * center_prior_saliency(frames) ** 0.5
    sal = gaussian_blur(sal[..., None], 5, 2.0)[..., 0]
    return _norm01(sal)


@functools.lru_cache(maxsize=4)
def _neural_saliency_fn(device: torch.device) -> SaliencyFn:
    """The shipped SaliencyNet on ``device``, loaded once per process and
    device; the motion-contrast heuristic when its weights file is absent
    (an untrained segmenter is not a usable mask source)."""
    from elvis_tpu_torch.models.io import load_saliency, weights_path
    from elvis_tpu_torch.models.saliency_net import make_neural_saliency_fn

    path = weights_path("saliency")
    if path is None:
        return motion_contrast_saliency
    return make_neural_saliency_fn(load_saliency(path, device))


@register_saliency("neural")
def neural_saliency(frames: torch.Tensor) -> torch.Tensor:
    """SaliencyNet (the UFO slot) on the frames' device; see
    ``_neural_saliency_fn`` for the load-once and fallback policy."""
    return _neural_saliency_fn(frames.device)(frames)


def saliency_to_block_mask(saliency: torch.Tensor, block_size: int,
                           threshold: float = 0.5) -> torch.Tensor:
    """Pixel saliency -> per-block foreground bool (block mean >= threshold)."""
    pooled = blockwise_reduce(saliency.float(), block_size, torch.mean)
    return pooled >= threshold
