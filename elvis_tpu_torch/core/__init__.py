from elvis_tpu_torch.core.blocks import (
    block_grid_shape,
    blockwise_reduce,
    combine_blocks,
    dilate_block_mask,
    split_into_blocks,
    upsample_map,
)

__all__ = [
    "block_grid_shape",
    "blockwise_reduce",
    "combine_blocks",
    "dilate_block_mask",
    "split_into_blocks",
    "upsample_map",
]
