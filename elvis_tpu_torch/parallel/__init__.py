from elvis_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_distributed,
    make_hybrid_mesh,
    process_local_batch,
)
from elvis_tpu_torch.parallel.halo import (
    spatial_tile_map,
    spatial_tile_map_blocks,
    temporal_map_overlap,
)
from elvis_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedFrames,
    devices,
    frame_sharding,
    make_mesh,
    resolve_devices,
    shard_frames,
)

__all__ = [
    "Mesh",
    "ShardedFrames",
    "devices",
    "frame_sharding",
    "initialize_distributed",
    "is_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "process_local_batch",
    "resolve_devices",
    "shard_frames",
    "spatial_tile_map",
    "spatial_tile_map_blocks",
    "temporal_map_overlap",
]
