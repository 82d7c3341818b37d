"""FVMD-style Frechet Video Motion Distance (port of ``elvis_tpu.metrics.fvmd``).

Block motion per frame pair (``ops.motion.block_motion_pyramid``) ->
velocity fields; acceleration = temporal difference of velocity ->
per-frame magnitude/angle histograms -> Frechet distance between the
Gaussian fits of the two clips' feature sequences. Features are computed
on the frames' device; the Gaussian statistics and the Frechet fit are
numpy float64 on the host, as in the JAX package.

The histogram edges are the float32 values the JAX package's jitted
extractor uses (``jnp.linspace`` constant-folded by XLA:
``start*(1-t) + stop*t`` with ``t = i/8``, no fused multiply-add). Integer
block motion puts angles exactly on edges, so one ulp moves a vector to
the next bin; ``torch.linspace`` differs from these at three of the nine
angle edges.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from elvis_tpu_torch.core.blocks import blockwise_reduce
from elvis_tpu_torch.ops.color import rgb_to_gray
from elvis_tpu_torch.ops.motion import block_motion_pyramid, pyramid_range

__all__ = [
    "motion_features", "frechet_distance", "fvmd", "fvmd_incremental",
    "region_motion_features", "fvmd_from_features", "hist_edges",
]


@functools.lru_cache(maxsize=16)
def hist_edges(start: float, stop: float, bins: int) -> np.ndarray:
    """``bins + 1`` float32 edges from ``start`` to ``stop``, computed as
    the JAX package's jitted ``jnp.linspace`` computes them."""
    t = np.arange(bins, dtype=np.float32) / np.float32(bins)
    inner = (np.float32(start) * (np.float32(1) - t) + np.float32(stop) * t).astype(np.float32)
    return np.append(inner, np.float32(stop))


def _velocity(frames: torch.Tensor, block_size: int, radius: int, levels: int):
    """Luma cropped to the block grid -> (N-1,By,Bx,2) float32 block motion
    and the crop (h, w)."""
    gray = rgb_to_gray(frames.float())
    h = (gray.shape[1] // block_size) * block_size
    w = (gray.shape[2] // block_size) * block_size
    gray = gray[:, :h, :w]
    vel = block_motion_pyramid(gray[:-1], gray[1:], block_size, radius, levels=levels)
    return vel.float(), (h, w)


def _features_from_velocity(vel, block_size, radius, bins, mask, levels, hw):
    acc = vel[1:] - vel[:-1]  # (N-2,By,Bx,2)
    if mask is not None:
        h, w = hw
        m = mask.float()[:, :h, :w]
        bw = blockwise_reduce(m, block_size, torch.mean)  # (N,By,Bx)
        # feature j spans frames j..j+2: weight by the region fraction at
        # the span's last frame
        wt = bw[2:].reshape(bw.shape[0] - 2, -1)
    else:
        wt = None

    def hists(field, max_mag):
        mag = torch.sqrt((field ** 2).sum(-1)).reshape(field.shape[0], -1)
        ang = torch.atan2(field[..., 0], field[..., 1]).reshape(field.shape[0], -1)
        dev = field.device

        def hist(x, edges):
            e = torch.as_tensor(edges, device=dev)
            idx = torch.clamp(torch.searchsorted(e, x.contiguous(), right=True) - 1, 0, bins - 1)
            onehot = (idx[..., None] == torch.arange(bins, device=dev)).float()
            hsum = (onehot * wt[..., None]).sum(dim=1) if wt is not None else onehot.sum(dim=1)
            return hsum / torch.clamp(hsum.sum(-1, keepdim=True), min=1e-6)

        return torch.cat([hist(mag, hist_edges(0.0, max_mag, bins)),
                          hist(ang, hist_edges(-np.pi, np.pi, bins))], dim=-1)

    reach = float(pyramid_range(radius, levels))
    vfeat = hists(vel[1:], max_mag=reach * 1.5)
    afeat = hists(acc, max_mag=reach)
    return torch.cat([vfeat, afeat], dim=-1)  # (N-2, 4*bins)


def motion_features(
    frames: torch.Tensor,
    block_size: int = 16,
    radius: int = 4,
    bins: int = 8,
    mask: "torch.Tensor | None" = None,
    levels: int = 3,
) -> torch.Tensor:
    """``(N,H,W,C)`` -> per-frame motion feature vectors ``(N-2, 4*bins)``:
    velocity magnitude/angle histograms + acceleration magnitude/angle.

    Motion comes from the coarse-to-fine pyramid search on the full frame;
    an optional ``mask`` (N,H,W in [0,1]) pools the histograms over region
    blocks, weighted by each block's region fraction. Frames are cropped
    to the block grid."""
    vel, hw = _velocity(frames, block_size, radius, levels)
    return _features_from_velocity(vel, block_size, radius, bins, mask, levels, hw)


def _frechet_from_stats(
    mu_a: np.ndarray, ca: np.ndarray, mu_b: np.ndarray, cb: np.ndarray
) -> float:
    diff = mu_a - mu_b
    # sqrtm via eigendecomposition of the symmetrized product
    evals, evecs = np.linalg.eigh(ca)
    sqrt_ca = (evecs * np.sqrt(np.maximum(evals, 0))) @ evecs.T
    m = sqrt_ca @ cb @ sqrt_ca
    mevals = np.linalg.eigvalsh((m + m.T) / 2)
    tr_sqrt = np.sqrt(np.maximum(mevals, 0)).sum()
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2 * tr_sqrt)


def frechet_distance(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """Frechet distance between Gaussian fits of two feature sets."""
    a = np.asarray(feat_a, dtype=np.float64)
    b = np.asarray(feat_b, dtype=np.float64)
    eye = 1e-8 * np.eye(a.shape[1])
    return _frechet_from_stats(
        a.mean(0), np.cov(a, rowvar=False) + eye,
        b.mean(0), np.cov(b, rowvar=False) + eye,
    )


class _RunningGaussian:
    """Prefix mean/covariance by running sums: O(d^2) per added frame."""

    def __init__(self, dim: int):
        self.n = 0
        self.s1 = np.zeros(dim)
        self.s2 = np.zeros((dim, dim))

    def add(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        self.n += 1
        self.s1 += x
        self.s2 += np.outer(x, x)

    def stats(self):
        mu = self.s1 / self.n
        # unbiased covariance (matches np.cov's ddof=1)
        denom = max(self.n - 1, 1)
        cov = (self.s2 - self.n * np.outer(mu, mu)) / denom
        return mu, cov + 1e-8 * np.eye(self.s1.size)


# Frames per motion-feature chunk: feature j needs frames j..j+2, so chunks
# overlap by 2 and the concatenated features equal a one-shot extraction.
_FVMD_CHUNK_FRAMES = 16


def _chunk_spans(n: int, chunk: int):
    """Yield (start, end, emit_from) frame spans: features ``start..end-3``
    are computed per span and emitted from global feature index
    ``emit_from``. Tail spans slide inward so every span has one shape."""
    if n <= chunk:
        yield 0, n, 0
        return
    j0 = 0
    s = 0
    while j0 < n - 2:
        e = min(s + chunk, n)
        if e - s < chunk:
            s, e = n - chunk, n
        yield s, e, j0
        j0 = e - 2
        s = e - 2


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _features_chunked(frames: torch.Tensor, mask, block_size: int, radius: int) -> np.ndarray:
    """Motion features over a clip, in overlapping frame chunks; an
    optional (N,H,W) mask pools each chunk's histograms."""
    n = int(frames.shape[0])
    feats = []
    for s, e, j0 in _chunk_spans(n, _FVMD_CHUNK_FRAMES):
        m = None if mask is None else mask[s:e].float()
        f = _host(motion_features(frames[s:e], block_size, radius, mask=m))
        feats.append(f[j0 - s:])
    return np.concatenate(feats)[: max(n - 2, 0)] if feats else np.zeros((0, 32))


def region_motion_features(
    frames: torch.Tensor,
    fg_mask: torch.Tensor,
    *,
    block_size: int = 16,
    radius: int = 4,
    stride: int = 1,
    max_frames: "int | None" = None,
):
    """(fg_features, bg_features) for one clip from ONE motion field per
    chunk (the two regions differ only in the block-weight pooling).
    ``(None, None)`` when fewer than 4 frames survive stride/max_frames."""
    r = frames[::stride] if stride > 1 else frames
    m = fg_mask[::stride] if stride > 1 else fg_mask
    if max_frames is not None:
        r, m = r[:max_frames], m[:max_frames]
    n = int(r.shape[0])
    if n < 4:
        return None, None
    levels, bins = 3, 8
    fg_feats, bg_feats = [], []
    for s, e, j0 in _chunk_spans(n, _FVMD_CHUNK_FRAMES):
        vel, hw = _velocity(r[s:e], block_size, radius, levels)
        mm = m[s:e].float()
        ff = _features_from_velocity(vel, block_size, radius, bins, mm, levels, hw)
        bf = _features_from_velocity(vel, block_size, radius, bins, 1.0 - mm, levels, hw)
        fg_feats.append(_host(ff)[j0 - s:])
        bg_feats.append(_host(bf)[j0 - s:])
    return (np.concatenate(fg_feats)[: n - 2],
            np.concatenate(bg_feats)[: n - 2])


def fvmd(
    ref_frames: torch.Tensor,
    dec_frames: torch.Tensor,
    block_size: int = 16,
    radius: int = 4,
    stride: int = 1,
) -> float:
    """Frechet video motion distance between two clips (lower = closer
    motion dynamics). Needs >= 4 frames. Full-clip features, one fit."""
    if ref_frames.shape[0] < 4:
        return float("nan")
    r = ref_frames[::stride] if stride > 1 else ref_frames
    d = dec_frames[::stride] if stride > 1 else dec_frames
    fa = _features_chunked(r, None, block_size, radius)
    fb = _features_chunked(d, None, block_size, radius)
    return frechet_distance(fa, fb)


def fvmd_incremental(
    ref_frames: torch.Tensor,
    dec_frames: torch.Tensor,
    *,
    block_size: int = 16,
    radius: int = 4,
    stride: int = 1,
    early_stop_delta: float = 0.002,
    window: int = 50,
    max_frames: "int | None" = None,
    mask: "torch.Tensor | None" = None,
) -> tuple:
    """FVMD with the incremental early stop: the estimate is recomputed
    over growing frame prefixes and stops when the sliding ``window`` of
    recent estimates moves less than ``early_stop_delta`` (relative).
    Returns ``(fvmd, fvmd_std)``, the std over the sliding window."""
    if ref_frames.shape[0] < 4:
        return float("nan"), float("nan")
    r = ref_frames[::stride] if stride > 1 else ref_frames
    d = dec_frames[::stride] if stride > 1 else dec_frames
    m = mask[::stride] if (mask is not None and stride > 1) else mask
    if max_frames is not None:
        r, d = r[:max_frames], d[:max_frames]
        m = m[:max_frames] if m is not None else None
    if r.shape[0] < 4:
        return float("nan"), float("nan")
    fa = _features_chunked(r, m, block_size, radius)
    fb = _features_chunked(d, m, block_size, radius)
    return fvmd_from_features(fa, fb, early_stop_delta=early_stop_delta, window=window)


def fvmd_from_features(
    fa: "np.ndarray | None",
    fb: "np.ndarray | None",
    *,
    early_stop_delta: float = 0.002,
    window: int = 50,
) -> tuple:
    """The incremental Frechet fit on precomputed feature sequences.
    Returns ``(nan, nan)`` for missing/short feature sequences."""
    if fa is None or fb is None or fa.shape[0] < 2 or fb.shape[0] < 2:
        return float("nan"), float("nan")
    estimates = []
    n_feat = min(fa.shape[0], fb.shape[0])
    start = min(4, n_feat)
    ga, gb = _RunningGaussian(fa.shape[1]), _RunningGaussian(fb.shape[1])
    for i in range(start - 1):
        ga.add(fa[i])
        gb.add(fb[i])
    for k in range(start, n_feat + 1):
        ga.add(fa[k - 1])
        gb.add(fb[k - 1])
        estimates.append(_frechet_from_stats(*ga.stats(), *gb.stats()))
        if early_stop_delta > 0 and len(estimates) >= window:
            recent = np.asarray(estimates[-window:])
            scale = max(abs(recent[-1]), 1e-9)
            if (np.abs(np.diff(recent)) / scale).mean() < early_stop_delta:
                break
    recent = np.asarray(estimates[-window:]) if estimates else np.asarray([np.nan])
    return float(estimates[-1]), float(recent.std())
