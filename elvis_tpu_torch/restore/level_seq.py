"""Level-sequential adaptive restore and the naive whole-frame restorers
(port of ``elvis_tpu.restore.level_seq``).

  * level-sequential: run a restorer once per degradation level (passing
    the level), then per block take the output of the matching level's
    pass. The adapter for restorers that take a scalar strength instead
    of a map.
  * naive SR: apply a 2x upsampler to the whole frame, ignoring the block
    maps, then area-resize back. A benchmark for how much the map-aware
    paths help.
  * naive diffusion: the diffusion sampler on the whole frame, ignoring
    the maps, under the out-of-memory policy of ``registry.safe_restore``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
from elvis_tpu_torch.models.diffusion import DiffusionRestorer
from elvis_tpu_torch.ops.resize import resize
from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x
from elvis_tpu_torch.restore.registry import register_restorer, safe_restore

__all__ = ["level_sequential_restore", "naive_sr_restore", "naive_diffusion_restore"]


def _finalize(dtype: torch.dtype, out: torch.Tensor) -> torch.Tensor:
    if not dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(dtype)


def level_sequential_restore(restore_fn: Callable[[torch.Tensor, int], torch.Tensor],
                             frames: torch.Tensor, level_maps: torch.Tensor,
                             block_size: int, max_level: int) -> torch.Tensor:
    """``restore_fn(frames, level) -> frames`` applied once per level
    1..max_level; each block takes the pass of its own level. Level-0
    blocks pass through untouched."""
    out_blocks = split_into_blocks(frames.float(), block_size)
    for lvl in range(1, max_level + 1):
        restored = split_into_blocks(restore_fn(frames, lvl).float(), block_size)
        sel = (level_maps == lvl)[..., None, None, None]
        out_blocks = torch.where(sel, restored, out_blocks)
    return _finalize(frames.dtype, combine_blocks(out_blocks))


@register_restorer("downsample", "naive_sr")
def naive_sr_restore(frames: torch.Tensor, level_maps: torch.Tensor, block_size: int,
                     upsample_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Whole-frame 2x SR then area resize back (map-blind)."""
    up = upsample_fn or lanczos_upsample_2x
    h, w = frames.shape[-3], frames.shape[-2]
    out = resize(up(frames.float()), (h, w), method="area")
    return _finalize(frames.dtype, out)


def _untrained_restorer(device: torch.device) -> DiffusionRestorer:
    """A DiffusionRestorer as initialized before training: conv and dense
    kernels drawn (LeCun normal) from ``torch.Generator().manual_seed(0)``,
    biases and the ``eps`` head zero. With the head zero every x0
    prediction is the clipped conditioning, whatever the other weights."""
    model = DiffusionRestorer(features=32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.unet.named_parameters():
            if name.startswith("eps.") or name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    return model.to(device).eval().requires_grad_(False)


@register_restorer("blur", "naive_diffusion")
def naive_diffusion_restore(frames: torch.Tensor, level_maps: torch.Tensor, block_size: int,
                            *, model: Optional[DiffusionRestorer] = None,
                            steps: int = 4) -> torch.Tensor:
    """Whole-frame diffusion restore (map-blind), ``steps`` DDIM steps of
    ``model`` (the untrained restorer when None, as in the JAX package);
    on a card out of memory, the input (``registry.safe_restore``)."""
    d = model if model is not None else _untrained_restorer(frames.device)
    out, err = safe_restore(lambda f: d.sample(f.float(), steps=steps), frames)
    if err is not None:
        return frames
    return _finalize(frames.dtype, out)
