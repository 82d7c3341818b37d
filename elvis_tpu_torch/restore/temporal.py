"""Temporal blending and halo-tile helpers (port of
``elvis_tpu.restore.temporal``).

  * temporal blend: each restored frame blended with the previous blended
    frame, ``out[t] = (1-tb)*frame[t] + tb*out[t-1]`` (a recurrence over
    the frame axis: a loop over frames on the device);
  * halo tiles: clamp-extended tile extraction with a context halo;
  * feathered tiling: a function applied per halo tile, the tiles blended
    back with linear feather ramps (float32 accumulate, weight-normalised).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["temporal_blend", "extract_halo_tiles", "feathered_tile_apply"]


def _to_input_type(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if not like.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(like.dtype)


def temporal_blend(frames: torch.Tensor, blend: float = 0.1) -> torch.Tensor:
    """IIR blend along the frame axis (frame 0 unchanged)."""
    if blend <= 0:
        return frames
    x = frames.float()
    out = [x[0]]
    for t in range(1, x.shape[0]):
        out.append((1.0 - blend) * x[t] + blend * out[-1])
    return _to_input_type(torch.stack(out), frames)


def extract_halo_tiles(frames: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
    """``(N,H,W,C)`` -> ``(N,Ty,Tx,tile+2*halo,tile+2*halo,C)`` with
    clamp-to-edge halos. H, W must be multiples of ``tile``."""
    n, h, w, c = frames.shape
    ty, tx = h // tile, w // tile
    # replicate-pad H and W (F.pad's replicate mode wants channels first)
    padded = F.pad(frames.permute(0, 3, 1, 2).float(), (halo, halo, halo, halo),
                   mode="replicate").permute(0, 2, 3, 1).to(frames.dtype)
    size = tile + 2 * halo
    rows = []
    for i in range(ty):
        rows.append(torch.stack([padded[:, i * tile: i * tile + size, j * tile: j * tile + size]
                                 for j in range(tx)], dim=1))
    return torch.stack(rows, dim=1)


def feathered_tile_apply(frames: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
                         tile: int, halo: int) -> torch.Tensor:
    """Apply ``fn`` per halo tile and re-assemble with linear feathering in
    the overlap (float32 accumulate, weights floored at 1e-8; integer
    frames rounded and clipped). ``fn`` maps ``(M,size,size,C)`` float32 to
    the same shape."""
    n, h, w, c = frames.shape
    ty, tx = h // tile, w // tile
    size = tile + 2 * halo
    tiles = extract_halo_tiles(frames, tile, halo)
    out_tiles = fn(tiles.reshape(n * ty * tx, size, size, c).float()).reshape(
        n, ty, tx, size, size, c)

    # linear feather ramp over the halo region
    ramp = torch.clamp(torch.arange(size, dtype=torch.float32, device=frames.device) + 1,
                       max=halo + 1) / (halo + 1)
    ramp = torch.minimum(ramp, ramp.flip(0))
    weight = ramp[:, None] * ramp[None, :]

    acc = torch.zeros((n, h + 2 * halo, w + 2 * halo, c), dtype=torch.float32,
                      device=frames.device)
    wacc = torch.zeros((n, h + 2 * halo, w + 2 * halo, 1), dtype=torch.float32,
                       device=frames.device)
    for i in range(ty):
        for j in range(tx):
            ys, xs = i * tile, j * tile
            acc[:, ys: ys + size, xs: xs + size] += out_tiles[:, i, j] * weight[..., None]
            wacc[:, ys: ys + size, xs: xs + size] += weight[..., None]
    out = (acc[:, halo: halo + h, halo: halo + w]
           / torch.clamp(wacc[:, halo: halo + h, halo: halo + w], min=1e-8))
    return _to_input_type(out, frames)
