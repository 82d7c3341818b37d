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
and use their plain PyTorch versions only for CPU tensors.
"""

__version__ = "0.1.0"
