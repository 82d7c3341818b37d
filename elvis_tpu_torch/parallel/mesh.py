"""Device mesh construction and frame-axis sharding (port of
``elvis_tpu.parallel.mesh``).

The JAX package is single-controller: one process drives every device of a
``jax.sharding.Mesh``. The port keeps that model. A :class:`Mesh` is an
array of ``torch.device`` with axis names; a sharded array
(:class:`ShardedFrames`) is the list of per-shard tensors, each on its
device, padded with edge repeats, and it records the original N so that
callers can trim.

:func:`devices` is the port's ``jax.devices()``: the visible devices of one
device type. torch has no virtual CPU devices, so a mesh may hold the same
device more than once (four logical shards on ``cpu`` or on ``cuda:0``);
tests get such meshes by replacing :func:`devices`, as the JAX package's
tests get eight CPU devices from ``XLA_FLAGS``.

Axis conventions:
  * ``data``    -- the frame axis;
  * ``tensor``  -- weight sharding for training (``train.trainer``);
  * ``spatial`` -- height tiling for full-frame restores (``parallel.halo``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["Mesh", "ShardedFrames", "devices", "resolve_devices", "make_mesh",
           "frame_sharding", "shard_frames"]

DeviceLike = Union[int, str, torch.device]


def devices(device_type: str = "cuda") -> List[torch.device]:
    """Every visible device of ``device_type``, in id order (the port's
    ``jax.devices()``): ``cuda:0..k-1``, or the one ``cpu``."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def resolve_devices(spec: Optional[Sequence[DeviceLike]] = None,
                    device_type: str = "cuda") -> List[torch.device]:
    """Normalise a device list (ints, ``'cuda:1'`` strings, ``torch.device``)
    to devices of ``devices(device_type)``, de-duplicated by id in order;
    None = all. An id is a position in that list; an absent one raises
    ``ValueError``."""
    all_devices = devices(device_type)
    if spec is None:
        return list(all_devices)
    out, seen = [], set()
    for item in spec:
        if isinstance(item, int):
            idx = item
        elif isinstance(item, str):
            s = item.rsplit(":", 1)
            idx = int(s[1]) if len(s) == 2 and s[1].isdigit() else 0
        elif isinstance(item, torch.device):
            idx = item.index or 0
        else:
            raise TypeError(f"not a device: {item!r}")
        if not 0 <= idx < len(all_devices):
            raise ValueError(f"device {item!r} not present (have ids 0..{len(all_devices) - 1})")
        if idx not in seen:
            seen.add(idx)
            out.append(all_devices[idx])
    return out


@dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of ``torch.device`` whose shape is the
    axis sizes, in the order of ``axis_names``. ``process_index``, set on a
    mesh that spans processes (``distributed.make_hybrid_mesh``), holds each
    entry's owning rank; a process drives only its own entries."""

    devices: np.ndarray
    axis_names: tuple
    process_index: Optional[np.ndarray] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        the single controller runs an array sharded on ``axis`` alone (the
        other axes hold replicas)."""
        sel = tuple(slice(None) if n == axis else 0 for n in self.axis_names)
        return list(self.devices[sel])


def make_mesh(axes: Sequence[tuple] = (("data", -1),),
              devices: Optional[Sequence[DeviceLike]] = None,
              device_type: str = "cuda") -> Mesh:
    """A mesh from ``(name, size)`` axes; one size may be -1 (inferred).

    ``make_mesh()`` -> a 1-D data mesh over every device;
    ``make_mesh((("data", -1), ("tensor", 2)))`` -> a 2-D DP x TP mesh."""
    devs = resolve_devices(devices, device_type)
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    n = len(devs)
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) if len(sizes) > 1 else 1
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), tuple(names))


@dataclass(frozen=True)
class FrameSharding:
    """The leading (frame) axis split over ``axis`` of ``mesh``."""

    mesh: Mesh
    axis: str = "data"
    ndim: int = 4

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.axis_devices(self.axis)


def frame_sharding(mesh: Mesh, axis: str = "data", ndim: int = 4) -> FrameSharding:
    """Sharding placing the leading (frame) axis across ``axis``."""
    return FrameSharding(mesh, axis, ndim)


@dataclass
class ShardedFrames:
    """Equal per-shard slices of a frame-axis array, ``shards[i]`` on
    ``sharding.devices[i]``; ``n`` is the length before padding."""

    shards: List[torch.Tensor]
    n: int
    sharding: FrameSharding

    @property
    def shape(self) -> tuple:
        """The padded array's shape (on a mesh over processes, the global
        one: ``shards`` then holds this process's shards only)."""
        size = self.sharding.mesh.shape[self.sharding.axis]
        return (size * int(self.shards[0].shape[0]),) + tuple(self.shards[0].shape[1:])

    def gather(self, device: "torch.device | None" = None) -> torch.Tensor:
        """The padded array on one device (shard 0's by default)."""
        device = self.shards[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.shards])


def shard_frames(frames: torch.Tensor, mesh: Mesh, axis: str = "data"):
    """``(ShardedFrames, n)``: a per-frame array (``(N, ...)``: frames, level
    maps, masks) split over ``axis``, N padded up to a multiple of the axis
    size with repeats of the last frame (callers trim to the ``n`` it
    returns)."""
    sharding = frame_sharding(mesh, axis, frames.ndim)
    size = mesh.shape[axis]
    n = int(frames.shape[0])
    pad = (-n) % size
    if pad:
        frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
    shards = [c.to(d) for c, d in zip(frames.chunk(size), sharding.devices)]
    return ShardedFrames(shards, n, sharding), n
