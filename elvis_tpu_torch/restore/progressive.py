"""Progressive adaptive super-resolution (port of
``elvis_tpu.restore.progressive``).

  1. downscale the degraded frame to 1/max_factor resolution (area);
  2. repeat: 2x upsample the whole frame with a pluggable ``upsample_fn``;
  3. after each stage, re-inject blocks whose downsample factor is <= the
     current stage factor from the (area-resized) degraded frame;
  4. until full resolution.

Under ``torch.profiler`` (``elvis_tpu_torch.utils.trace.span``) a call
records ``restore.progressive`` and, inside it, ``restore.levels`` (the host
read of the largest level, when ``max_level`` is not given) and one
``restore.upsample`` per stage (the stage's upsampler, net or Lanczos, with
the phase interleave); what lies outside those is the loop's own work.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from elvis_tpu_torch.core.blocks import upsample_map
from elvis_tpu_torch.ops.resize import interleave_phases, resize
from elvis_tpu_torch.restore.registry import register_restorer
from elvis_tpu_torch.utils.trace import span

__all__ = ["progressive_restore", "lanczos_upsample_2x", "StagedUpsampler"]

UpsampleFn = Callable[[torch.Tensor], torch.Tensor]


class StagedUpsampler(NamedTuple):
    """``prefix`` runs on every stage except the last, ``final`` on the last."""

    prefix: UpsampleFn
    final: UpsampleFn


def lanczos_upsample_2x(frames: torch.Tensor) -> torch.Tensor:
    h, w = frames.shape[-3], frames.shape[-2]
    return resize(frames, (2 * h, 2 * w), method="lanczos4")


def progressive_restore(frames: torch.Tensor, level_maps: torch.Tensor, block_size: int,
                        upsample_fn: "UpsampleFn | StagedUpsampler | tuple | list" = lanczos_upsample_2x,
                        *, max_level: "int | None" = None) -> torch.Tensor:
    """frames ``(N,H,W,C)`` degraded, level_maps ``(N,By,Bx)`` int levels
    (factor = 2^level) -> restored ``(N,H,W,C)`` in the input dtype.

    ``max_level`` defaults to the max of ``level_maps`` (read on the host).
    ``upsample_fn`` may be one 2x upsampler, a ``StagedUpsampler``, or a
    sequence of ``max_level`` per-stage upsamplers (coarsest first). An
    upsampler with a ``phase_fn`` attribute runs in phase form.
    """
    with span("restore.progressive"):
        if max_level is None:
            with span("restore.levels"):
                max_level = (int(level_maps.max()) if level_maps.numel()
                             else int(math.log2(block_size)))
        if max_level == 0:
            return frames
        if isinstance(upsample_fn, StagedUpsampler):
            stage_fns = [upsample_fn.prefix] * (max_level - 1) + [upsample_fn.final]
        elif callable(upsample_fn):
            stage_fns = [upsample_fn] * max_level
        else:
            stage_fns = list(upsample_fn)
            if len(stage_fns) != max_level:
                raise ValueError(f"need one upsample_fn per stage: got {len(stage_fns)}, "
                                 f"max_level={max_level}")

        n, h, w, c = frames.shape
        orig_dtype = frames.dtype
        x = frames.float()
        max_factor = 2**max_level

        current = resize(x, (h // max_factor, w // max_factor), method="area")
        factors = torch.pow(2, level_maps.to(torch.int32))  # (N,By,Bx)

        current_factor = max_factor // 2
        for fn in stage_fns:
            cur_h, cur_w = h // current_factor, w // current_factor
            phase_fn = getattr(fn, "phase_fn", None)
            with span("restore.upsample"):
                if phase_fn is not None:
                    current = interleave_phases(phase_fn(current))
                else:
                    current = fn(current)
            if tuple(current.shape[-3:]) != (cur_h, cur_w, c):
                raise ValueError(f"upsample_fn produced {tuple(current.shape)}, "
                                 f"expected (*,{cur_h},{cur_w},{c})")
            degraded_at_res = resize(x, (cur_h, cur_w), method="area")
            inject = factors <= current_factor  # blocks authentic at this resolution
            pix = upsample_map(inject, block_size // current_factor)[..., None]
            current = torch.where(pix, degraded_at_res, current.float())
            current_factor //= 2

        if not orig_dtype.is_floating_point:
            current = torch.clamp(torch.round(current), 0, 255)
        return current.to(orig_dtype)


@register_restorer("downsample", "progressive_lanczos")
def _progressive_lanczos(frames, level_maps, block_size, **kw):
    return progressive_restore(frames, level_maps, block_size,
                               upsample_fn=lanczos_upsample_2x, **kw)
