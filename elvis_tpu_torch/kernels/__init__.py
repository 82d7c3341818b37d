from elvis_tpu_torch.kernels.block_transform import (
    LAUNCHES,
    apply_block_matrix,
    apply_block_matrix_batched_cuda,
    apply_block_matrix_cuda,
    apply_block_matrix_fast,
    blur_matrix_table,
    conv_matrix_reflect101,
    resample_matrix_table,
)

__all__ = [
    "LAUNCHES",
    "apply_block_matrix",
    "apply_block_matrix_batched_cuda",
    "apply_block_matrix_cuda",
    "apply_block_matrix_fast",
    "blur_matrix_table",
    "conv_matrix_reflect101",
    "resample_matrix_table",
]
