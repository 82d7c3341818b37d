"""Halo exchange: temporal overlap and spatial tiling on the mesh (port of
``elvis_tpu.parallel.halo``).

The JAX package runs each function as one ``shard_map`` whose shards swap
boundary frames (or rows) with ``jax.lax.ppermute``. Here one controller
walks the shards: a shard's halo is copied from its ring neighbours'
tensors (``.to(shard device)``, the counterpart of ``ppermute``), ``fn``
runs on the extended shard on its device, and the result is trimmed and
gathered onto the input's device.

Global edges: :func:`temporal_map_overlap` and :func:`spatial_tile_map`
replicate the edge frame or row (they do not wrap); a per-pair array of
:func:`temporal_map_overlap` named in ``zero_edge`` (a motion field: ``mv[t]``
the motion from frame t-1 to t) gets zeros there instead, since replicated
frames do not move. The JAX package replicates the field too, which puts
the last pair's motion between copies of the last frame: the port's
sharded fill with a motion hint equals its unsharded fill, where JAX's
differs on the clip's last frame (an intended divergence);
:func:`spatial_tile_map_blocks` slides the window at the top and bottom
tiles instead, all ``2*halo`` rows from the inward neighbour, so the
restorer's own edge handling matches the unsharded call.

Inputs are tensors (the whole array, on any device) or
:class:`~elvis_tpu_torch.parallel.mesh.ShardedFrames` from ``shard_frames``
(whose padded length must then divide as the function requires).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from elvis_tpu_torch.parallel.mesh import Mesh, ShardedFrames

__all__ = ["temporal_map_overlap", "spatial_tile_map", "spatial_tile_map_blocks"]


def _home(x) -> torch.device:
    return x.shards[0].device if isinstance(x, ShardedFrames) else x.device


def _split(x, devs: List[torch.device], dim: int) -> List[torch.Tensor]:
    """``x`` as ``len(devs)`` equal slices along ``dim``, slice i on devs[i]."""
    if isinstance(x, ShardedFrames):
        if dim == 0 and [s.device for s in x.shards] == list(devs):
            return list(x.shards)
        x = x.gather()
    k = len(devs)
    if x.shape[dim] % k:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} not divisible by {k} shards")
    return [c.to(d) for c, d in zip(x.chunk(k, dim), devs)]


def _edge_halo(locs: List[torch.Tensor], i: int, overlap: int, dim: int, zero: bool = False):
    """(before, after) halo of shard ``i`` along ``dim`` from its ring
    neighbours; the global first and last shards replicate their own edge
    slice instead of wrapping, or hold zeros with ``zero``."""
    loc = locs[i]
    size = loc.shape[dim]
    reps = [1] * loc.ndim
    reps[dim] = overlap

    def edge(start):
        if zero:
            return torch.zeros_like(loc.narrow(dim, 0, 1)).repeat(reps)
        return loc.narrow(dim, start, 1).repeat(reps)

    if i == 0:
        before = edge(0)
    else:
        before = locs[i - 1].narrow(dim, size - overlap, overlap).to(loc.device)
    if i == len(locs) - 1:
        after = edge(size - 1)
    else:
        after = locs[i + 1].narrow(dim, 0, overlap).to(loc.device)
    return before, after


def temporal_map_overlap(fn: Callable, frames, mesh: Mesh, overlap: int,
                         axis: str = "data", zero_edge: Sequence[bool] = ()) -> torch.Tensor:
    """Apply a windowed temporal model per shard with halo context.

    ``frames`` is one array or a tuple of arrays sharing the leading
    (frame) axis, e.g. (frames, per-frame masks); every array gets the same
    halo and ``fn`` receives the extended versions in order. ``fn`` maps
    ``(n_local + 2*overlap, ...)`` to the same length; each shard keeps its
    own ``n_local`` frames. N must divide by the axis size (pad with
    ``shard_frames``) and ``n_local >= overlap``. ``zero_edge[k]`` true:
    array k's halo past the clip's ends is zeros (a per-pair motion field),
    not its replicated edge frame."""
    is_multi = isinstance(frames, (tuple, list))
    arrays = tuple(frames) if is_multi else (frames,)
    devs = mesh.axis_devices(axis)
    n = int(arrays[0].shape[0])
    if n % len(devs):
        raise ValueError(f"frames {n} not divisible by mesh axis {len(devs)}")
    n_local = n // len(devs)
    if n_local < overlap:
        raise ValueError(f"local chunk {n_local} smaller than overlap {overlap}")
    home = _home(arrays[0])
    shards = [_split(a, devs, 0) for a in arrays]
    outs = []
    for i in range(len(devs)):
        ext = []
        for k, locs in enumerate(shards):
            zero = k < len(zero_edge) and bool(zero_edge[k])
            before, after = _edge_halo(locs, i, overlap, 0, zero)
            ext.append(torch.cat([before, locs[i], after]))
        out = fn(*ext) if is_multi else fn(ext[0])
        outs.append(out[overlap: overlap + n_local].to(home))
    return torch.cat(outs)


def spatial_tile_map(fn: Callable[[torch.Tensor], torch.Tensor], frames, mesh: Mesh,
                     halo: int, axis: str = "spatial") -> torch.Tensor:
    """Shard the HEIGHT axis over ``axis`` with a row halo from the
    neighbouring tiles (edge rows replicated at the frame's top and bottom).
    ``fn`` maps ``(N, h_local + 2*halo, W, C)`` to the same shape; the halo
    rows are trimmed on return."""
    devs = mesh.axis_devices(axis)
    home = _home(frames)
    locs = _split(frames, devs, 1)
    outs = []
    for i, loc in enumerate(locs):
        top, bottom = _edge_halo(locs, i, halo, 1)
        out = fn(torch.cat([top, loc, bottom], dim=1))
        outs.append(out[:, halo: halo + loc.shape[1]].to(home))
    return torch.cat(outs, dim=1)


def _clamped_extend(locs: List[torch.Tensor], j: int, hl: int, dim: int):
    """(extended tile of ``local + 2*hl`` along ``dim``, row of the local
    tile in it): a symmetric halo for interior tiles, a window slid to the
    global edge for the first and last (ring neighbours, as ``ppermute``)."""
    loc = locs[j]
    size, n_sp = loc.shape[dim], len(locs)
    from_prev = locs[(j - 1) % n_sp].narrow(dim, size - 2 * hl, 2 * hl).to(loc.device)
    from_next = locs[(j + 1) % n_sp].narrow(dim, 0, 2 * hl).to(loc.device)
    if j == 0:
        return torch.cat([loc, from_next], dim=dim), 0
    if j == n_sp - 1:
        return torch.cat([from_prev, loc], dim=dim), 2 * hl
    return torch.cat([from_prev.narrow(dim, hl, hl), loc, from_next.narrow(dim, 0, hl)],
                     dim=dim), hl


def spatial_tile_map_blocks(fn: Callable, frames, levels, mesh: Mesh, halo: int,
                            block_size: int, axis: str = "spatial",
                            data_axis: "str | None" = None) -> torch.Tensor:
    """Height-sharded RESTORE with a pixel halo plus the matching block-grid
    halo of the degradation map: the production spatial tiling for
    full-frame restorers on tall frames.

    ``frames`` ``(N, H, W, C)`` sharded on H; ``levels`` ``(N, By, Bx)``
    sharded on By (``H / block_size``) with a halo of ``halo // block_size``
    blocks. ``fn(frames_ext, levels_ext)`` maps an extended tile to the
    restored tile (same shape). Interior seams get a symmetric halo; the
    top and bottom tiles a slid window that ends at the frame's edge (edge
    replication there measured ~9/255 of error in the JAX package; the slid
    window is exact). With a halo covering the receptive field the result
    equals the unsharded one (progressive SR at max_level 3: halo >= 32).
    ``data_axis`` also splits the frame axis (a 2-D data x spatial mesh).

    Preconditions (``ValueError``): ``halo % block_size == 0``,
    ``H % (n_spatial * block_size) == 0``, ``H // n_spatial >= 2 * halo``,
    and N divisible by the data axis."""
    n_sp = mesh.shape[axis]
    h = int(frames.shape[1])
    if halo % block_size:
        raise ValueError(f"halo {halo} not a multiple of block_size {block_size}")
    if h % (n_sp * block_size):
        raise ValueError(f"height {h} not divisible by {n_sp} tiles of block {block_size}")
    if h // n_sp < 2 * halo:
        raise ValueError(f"tile height {h // n_sp} smaller than 2*halo={2 * halo}")
    bhalo = halo // block_size
    home = _home(frames)
    names = mesh.axis_names
    n_data = mesh.shape[data_axis] if data_axis else 1

    def device(i, j):
        return mesh.devices[tuple(j if a == axis else (i if a == data_axis else 0)
                                  for a in names)]

    f_rows = _split(frames, [home] * n_data, 0)
    l_rows = _split(levels, [home] * n_data, 0)
    rows = []
    for i in range(n_data):
        devs = [device(i, j) for j in range(n_sp)]
        f_locs = _split(f_rows[i], devs, 1)
        l_locs = _split(l_rows[i], devs, 1)
        tiles = []
        for j in range(n_sp):
            f_ext, start = _clamped_extend(f_locs, j, halo, 1)
            l_ext, _ = _clamped_extend(l_locs, j, bhalo, 1)
            out = fn(f_ext, l_ext)
            tiles.append(out[:, start: start + f_locs[j].shape[1]].to(home))
        rows.append(torch.cat(tiles, dim=1))
    return torch.cat(rows)
