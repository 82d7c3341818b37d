"""Multi-process mesh support on ``torch.distributed`` (port of
``elvis_tpu.parallel.distributed``).

Every process runs the same program and drives its own devices; a process
group federates them. The environment contract is the JAX package's:
``ELVIS_TPU_COORDINATOR`` (``host:port``), ``ELVIS_TPU_NUM_PROCESSES`` and
``ELVIS_TPU_PROCESS_ID``. The backend is ``nccl`` for a CUDA mesh and
``gloo`` for a CPU mesh.

Axis placement (the JAX package's policy): the frame / data axis spans
processes, since frame-parallel stages exchange nothing but halo frames;
``tensor`` and ``spatial`` axes stay inside a process.
:func:`make_hybrid_mesh` builds that layout; on one process it is
``make_mesh`` exactly.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from elvis_tpu_torch.parallel import mesh as _mesh
from elvis_tpu_torch.parallel.mesh import Mesh, ShardedFrames, frame_sharding, make_mesh

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "make_hybrid_mesh",
    "process_local_batch",
]

_ENV_COORD = "ELVIS_TPU_COORDINATOR"
_ENV_NPROC = "ELVIS_TPU_NUM_PROCESSES"
_ENV_PID = "ELVIS_TPU_PROCESS_ID"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda") -> bool:
    """Join the process group; True if the run spans processes.

    Arguments fall back to ``ELVIS_TPU_COORDINATOR`` /
    ``ELVIS_TPU_NUM_PROCESSES`` / ``ELVIS_TPU_PROCESS_ID``. With no
    coordinator and no process count configured it is a no-op. Idempotent.
    ``device_type`` picks the backend: ``nccl`` for ``"cuda"``, else
    ``gloo``."""
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes is None:
        return is_distributed()
    if dist.is_initialized():
        return is_distributed()
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the number "
                         "of processes and this process's id")
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method=init,
                            world_size=int(num_processes), rank=int(process_id))
    return is_distributed()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def make_hybrid_mesh(ici_axes: Sequence[tuple] = (), dcn_axis: str = "data",
                     device_type: str = "cuda") -> Mesh:
    """Mesh whose ``dcn_axis`` spans processes and whose ``ici_axes``
    ``(name, size)`` tile each process's own devices.

    One process: ``make_mesh(((dcn_axis, -1), *ici_axes))``. More: every
    process's devices are stacked process-major along ``dcn_axis``, so only
    that axis crosses a process boundary; ``process_index`` records each
    entry's owner. Every process must report the same local device count
    (a rectangular mesh); raises ``ValueError`` otherwise."""
    ici_axes = tuple(ici_axes)
    names = (dcn_axis,) + tuple(n for n, _ in ici_axes)
    if not is_distributed():
        return make_mesh(((dcn_axis, -1),) + ici_axes, device_type=device_type)
    ici_sizes = [s for _, s in ici_axes]
    known = int(np.prod(ici_sizes)) if ici_sizes else 1
    local = len(_mesh.devices(device_type))
    if local % known:
        raise ValueError(f"{local} local devices not divisible by ici axes {ici_sizes}")
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    if len(set(counts)) > 1:
        raise ValueError(f"processes report unequal local device counts "
                         f"{dict(enumerate(counts))}; a rectangular hybrid mesh needs the "
                         "same count per process")
    shape = [local // known] + ici_sizes
    blocks, owners = [], []
    for p in range(len(counts)):
        arr = np.empty(local, dtype=object)
        arr[:] = [torch.device(device_type, i) if device_type == "cuda"
                  else torch.device(device_type) for i in range(local)]
        blocks.append(arr.reshape(shape))
        owners.append(np.full(shape, p))
    return Mesh(np.concatenate(blocks), names, np.concatenate(owners))


def process_local_batch(global_array: torch.Tensor, mesh: Mesh,
                        axis: str = "data") -> ShardedFrames:
    """This process's slice of a batch sharded along ``axis``: each process
    feeds only its own rows of the frame axis (the multi-host input
    pipeline). ``global_array`` is this PROCESS's slice; the result's
    ``shape`` is the global one, ``(process_count * local_n, ...)``, and its
    ``shards`` are this process's, one per local position of ``axis``. On
    one process, the batch split over the axis. The local N must divide by
    the local positions (``ValueError``)."""
    sharding = frame_sharding(mesh, axis, global_array.ndim)
    devs = sharding.devices
    if mesh.process_index is None:
        local = range(len(devs))
        nproc = 1
    else:
        sel = tuple(slice(None) if n == axis else 0 for n in mesh.axis_names)
        owners = mesh.process_index[sel]
        local = [i for i, p in enumerate(owners) if p == dist.get_rank()]
        nproc = len(set(owners.tolist()))
    n_local = int(global_array.shape[0])
    if n_local % len(local):
        raise ValueError(f"{n_local} local frames not divisible by {len(local)} shards")
    shards = [c.to(devs[i]) for c, i in zip(global_array.chunk(len(local)), local)]
    return ShardedFrames(shards, n_local * nproc, sharding)
