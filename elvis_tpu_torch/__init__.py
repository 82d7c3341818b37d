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

Subpackages, each the counterpart of the JAX package's of the same name:
``core`` (block algebra), ``ops`` (resize, filters, colour incl. planar
YUV 4:2:0, DCT and inverse DCT), ``kernels``, ``scoring``, ``degrade``,
``models``, ``restore``, ``metrics``, ``pipeline`` (``ElvisConfig``) and
``codec``: the NVC codec (``codec.nvc.transform``: ``encode_plane``,
``decode_plane``, ``encode_plane_b``, ``decode_plane_b``;
``codec.nvc.codec``: ``encode``, ``decode``, ``NvcCodec``;
``codec.nvc.entropy``: the range coder, built from
``codec/nvc/csrc/rangecoder.cpp`` by the host compiler at first use), the
strength-map and removal-mask sidecars (``codec.sidecar``) and the
pipeline's adapter (``codec.dispatch.make_pipeline_codec``). The codec's
device half is stock PyTorch ops, as the JAX package's is XLA ops.
"""

__version__ = "0.1.0"
