"""elvis-tpu on PyTorch and CUDA: the port of ``elvis_tpu`` to one NVIDIA H100.

The module layout and public names follow ``elvis_tpu`` so each function
has an obvious counterpart (``elvis_tpu_torch.degrade.adaptive.
adaptive_downsample`` ports ``elvis_tpu.degrade.adaptive.
adaptive_downsample``, and so on). Public functions keep the JAX package's
layouts: NHWC frames, ``(N, By, Bx)`` block maps.

Functions that take tensors run on the tensors' device. Entry points that
create tensors or load models take ``device="cuda"`` by default and raise
when no card is present; pass ``device="cpu"`` explicitly for a CPU run.
Hand-written kernels (``elvis_tpu_torch.kernels``) launch on CUDA tensors
and use their plain PyTorch versions only for CPU tensors. There are two,
both CUDA C++ for ``sm_90a`` and both the per-block transform
``T[idx] @ X @ T[idx].T``:

  * ``kernels/csrc/block_transform.cu`` (``apply_table_to_frames``, what the
    degrade functions, the per-block Lanczos restorers and the unsharp mask
    launch once per call on the frames as they lie in memory, and
    ``apply_block_matrix_cuda`` / ``apply_block_matrix_fast`` on blocks)
    replaces the TPU kernel
    ``elvis_tpu.kernels.block_transform.apply_block_matrix_pallas_kron``;
  * ``kernels/csrc/block_transform_batched.cu``
    (``apply_block_matrix_batched_cuda``) replaces the TPU kernel
    ``elvis_tpu.kernels.block_transform.apply_block_matrix_pallas``.

Both share their arithmetic, ``kernels/csrc/block_transform_core.cuh``.
"""

__version__ = "0.1.0"
