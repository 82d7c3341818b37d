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

The pipeline runs end to end: ``pipeline.run_elvis(config, device=...)``,
or ``python -m elvis_tpu_torch.cli`` on the card, writes the JAX package's
``analysis_results.json``.

Subpackages, each the counterpart of the JAX package's of the same name:
``core`` (block algebra), ``ops`` (resize, filters, colour incl. planar
YUV 4:2:0, DCT and inverse DCT, block motion), ``kernels``, ``scoring``,
``degrade`` (adaptive downsample and blur, block removal), ``models``,
``restore`` (SR, deblur, classical, the PDE fill, temporal blend),
``metrics`` (masked PSNR/SSIM/MSE, LPIPS, FVMD, VMAF, the evaluation
fan-out and report), ``pipeline`` (``ElvisConfig``, clip I/O, the stage
cache, ``run_elvis``), ``parallel`` (the device mesh, halo exchange, the
multi-process runtime on ``torch.distributed``), ``train`` (the sharded
trainer, the training data, the trainers' CLI), ``utils`` and ``codec``: the NVC codec (``codec.nvc.transform``: ``encode_plane``,
``decode_plane``, ``encode_plane_b``, ``decode_plane_b``;
``codec.nvc.codec``: ``encode``, ``decode``, ``NvcCodec``;
``codec.nvc.entropy``: the range coder, built from
``codec/nvc/csrc/rangecoder.cpp`` by the host compiler at first use), the
strength-map and removal-mask sidecars (``codec.sidecar``), Y4M
(``codec.y4m``) and the pipeline's adapter
(``codec.dispatch.make_pipeline_codec``). The codec's
device half is stock PyTorch ops, as the JAX package's is XLA ops.
"""

from elvis_tpu_torch.version import __version__  # noqa: E402,F401
