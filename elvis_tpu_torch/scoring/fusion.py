"""Score fusion (port of ``elvis_tpu.scoring.fusion``).

  * removability: norm SC, TC to [0,1] over the clip;
    scores[:-1] = alpha*SC[:-1] + (1-alpha)*TC[1:]; scores[-1] = SC[-1];
    background blocks *= 10; beta smoothing over time; min-max normalize.
  * importance: the same alpha fusion and beta smoothing on raw SC/TC,
    times -1 where the block foreground weight < 0.5 (the weight itself
    elsewhere), min-max normalized per frame.
"""

from __future__ import annotations

import torch

from elvis_tpu_torch.utils.trace import span

__all__ = ["normalize01", "removability_scores", "importance_scores"]


def normalize01(x: torch.Tensor, axis=None) -> torch.Tensor:
    if axis is None:
        lo, hi = x.amin(), x.amax()
    else:
        lo, hi = x.amin(dim=axis, keepdim=True), x.amax(dim=axis, keepdim=True)
    return (x - lo) / (hi - lo + 1e-8)


def _alpha_fuse(sc: torch.Tensor, tc: torch.Tensor, alpha: float) -> torch.Tensor:
    fused_head = alpha * sc[:-1] + (1 - alpha) * tc[1:]
    return torch.cat([fused_head, sc[-1:]], dim=0)


def _beta_smooth(scores: torch.Tensor, beta: float) -> torch.Tensor:
    if scores.shape[0] < 2 or beta >= 1:
        return scores
    tail = beta * scores[1:] + (1 - beta) * scores[:-1]
    return torch.cat([scores[:1], tail], dim=0)


def removability_scores(sc: torch.Tensor, tc: torch.Tensor, block_fg_mask: torch.Tensor,
                        alpha: float = 0.5, smoothing_beta: float = 0.5,
                        background_boost: float = 10.0) -> torch.Tensor:
    """``(N,By,Bx)`` SC/TC + boolean fg mask -> removability in [0,1]
    (high = safe to degrade). Span ``score.fusion``."""
    with span("score.fusion"):
        scores = _alpha_fuse(normalize01(sc), normalize01(tc), alpha)
        scores = torch.where(block_fg_mask, scores, scores * background_boost)
        scores = _beta_smooth(scores, smoothing_beta)
        return normalize01(scores)


def importance_scores(sc: torch.Tensor, tc: torch.Tensor, block_fg_weight: torch.Tensor,
                      alpha: float = 0.5, beta: float = 0.5) -> torch.Tensor:
    """PRESLEY importance (high = keep quality); ``block_fg_weight`` float
    in [0,1], weights < 0.5 replaced by -1 before the per-frame normalize.
    Span ``score.fusion``."""
    with span("score.fusion"):
        scores = _beta_smooth(_alpha_fuse(sc, tc, alpha), beta)
        fg = torch.where(block_fg_weight < 0.5, -1.0, block_fg_weight)
        return normalize01(scores * fg, axis=(1, 2))
