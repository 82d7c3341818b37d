"""Per-block matrix transforms (port of ``elvis_tpu.kernels.block_transform``).

Every per-block separable op of the degradation and restore paths is
``T[idx] @ X @ T[idx].T`` per block and channel, with T gathered from a
small ``(L, b, b)`` host table by each block's level: ``R_l = Up_l @ Down_l``
for the adaptive downsample, ``B^r`` for r within-block blur rounds.

  * ``conv_matrix_reflect101`` / ``blur_matrix_table`` /
    ``resample_matrix_table`` — the host tables (numpy, float64);
  * ``apply_block_matrix`` — the plain PyTorch version (gather + two
    einsums). The CPU path, and the comparison target on the card;
  * ``apply_block_matrix_cuda`` — the hand-written CUDA kernel
    (``csrc/block_transform.cu``), replacing the TPU kernel
    ``apply_block_matrix_pallas_kron``. CUDA tensors only;
  * ``apply_block_matrix_fast`` — what the call sites use: an autograd
    function whose forward and backward (the same transform with T^T) go
    through the kernel on CUDA tensors and through the plain version on
    CPU tensors.

``LAUNCHES["block_transform"]`` counts the kernel's launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.ops.filter import _reflect101_indices, gaussian_kernel_1d
from elvis_tpu_torch.ops.resize import resize_matrix

__all__ = [
    "LAUNCHES",
    "conv_matrix_reflect101",
    "blur_matrix_table",
    "resample_matrix_table",
    "apply_block_matrix",
    "apply_block_matrix_cuda",
    "apply_block_matrix_fast",
]

# Kernel launches by kernel name; each wrapper adds one where it launches.
LAUNCHES: "collections.Counter[str]" = collections.Counter()


@functools.lru_cache(maxsize=64)
def conv_matrix_reflect101(b: int, ksize: int = 5, sigma: float = 1.0) -> np.ndarray:
    """(b, b) matrix equivalent of a 1-D ksize/sigma Gaussian correlation
    with OpenCV reflect-101 borders on a length-b signal."""
    kern = gaussian_kernel_1d(ksize, sigma)
    pad = (ksize - 1) // 2
    idx = _reflect101_indices(b, pad)
    mat = np.zeros((b, b), dtype=np.float64)
    for out_i in range(b):
        for t in range(ksize):
            mat[out_i, idx[out_i + t]] += kern[t]
    return mat


@functools.lru_cache(maxsize=32)
def blur_matrix_table(b: int, max_rounds: int, ksize: int = 5, sigma: float = 1.0) -> np.ndarray:
    """(max_rounds+1, b, b): entry r = B^r (r iterated within-block blurs)."""
    base = conv_matrix_reflect101(b, ksize, sigma)
    out = [np.eye(b)]
    cur = np.eye(b)
    for _ in range(max_rounds):
        cur = base @ cur
        out.append(cur)
    return np.stack(out, axis=0)


@functools.lru_cache(maxsize=32)
def resample_matrix_table(b: int, up_method: str = "linear",
                          max_level: "int | None" = None) -> np.ndarray:
    """(L+1, b, b): entry l = Up_l @ Down_l — area downsample to b/2^l
    then ``up_method`` upsample back (level 0 = identity)."""
    if max_level is None:
        max_level = int(math.log2(b))
    out = [np.eye(b)]
    for lvl in range(1, max_level + 1):
        small = max(1, b // (2**lvl))
        down = resize_matrix(small, b, "area")
        up = resize_matrix(b, small, up_method)
        out.append(up @ down)
    return np.stack(out, axis=0)


def apply_block_matrix(blocks: torch.Tensor, table: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Plain version: blocks ``(..., b, b, C)``, table ``(L, b, b)``, idx
    ``(...,)`` int -> ``T[idx] @ X @ T[idx].T`` per block, float32."""
    t = torch.as_tensor(table, dtype=torch.float32, device=blocks.device)[idx.long()]
    x = blocks.float()
    with full_fp32():
        y = torch.einsum("...ij,...jkc->...ikc", t, x)
        return torch.einsum("...lk,...ikc->...ilc", t, y)


_SMEM_BUDGET = 26 * 1024  # bytes per CTA: 8 CTAs of 256 threads fit on one SM


def _group_size(b: int, c: int, levels: int) -> int:
    """Blocks per CTA: X and Y tiles (2 * b*b*c floats each) plus one level
    per block, beside the table, within the shared-memory budget."""
    return (_SMEM_BUDGET - levels * b * b * 4) // (8 * b * b * c + 4)


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    from elvis_tpu_torch.kernels import _build

    fn = _build.load("block_transform").elvis_block_transform
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def apply_block_matrix_cuda(blocks: torch.Tensor, table: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: blocks ``(M, b, b, C)`` float32, table ``(L, b, b)``
    float32, idx ``(M,)`` int32, all contiguous on one CUDA device;
    b in {8, 16}, 1 <= L <= 16. Returns a new ``(M, b, b, C)`` float32."""
    if not (blocks.is_cuda and table.is_cuda and idx.is_cuda):
        raise ValueError("apply_block_matrix_cuda takes CUDA tensors only")
    if not (blocks.device == table.device == idx.device):
        raise ValueError("blocks, table and idx must lie on one device")
    if blocks.dtype != torch.float32 or table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("blocks and table must be float32 and idx int32, got "
                        f"{blocks.dtype}, {table.dtype}, {idx.dtype}")
    if blocks.dim() != 4 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (M, b, b, C), got {tuple(blocks.shape)}")
    m, b, _, c = blocks.shape
    if b not in (8, 16):
        raise ValueError(f"block size {b} not supported (8 or 16)")
    if table.dim() != 3 or tuple(table.shape[1:]) != (b, b) or not 1 <= table.shape[0] <= 16:
        raise ValueError(f"table must be (L, {b}, {b}) with 1 <= L <= 16, "
                         f"got {tuple(table.shape)}")
    if tuple(idx.shape) != (m,):
        raise ValueError(f"idx must be ({m},), got {tuple(idx.shape)}")
    if not (blocks.is_contiguous() and table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("blocks, table and idx must be contiguous")
    levels = table.shape[0]
    group = _group_size(b, c, levels)
    if group < 1:
        raise ValueError(f"{c} channels do not fit the kernel's shared-memory tile")
    out = torch.empty_like(blocks)
    if m == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = fn(blocks.data_ptr(), table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 m, b, c, levels, group, stream)
        LAUNCHES["block_transform"] += 1
    if err != 0:
        raise RuntimeError(f"block_transform kernel launch failed: CUDA error {err}")
    return out


def _transform(blocks: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(..., b, b, C)`` blocks through the kernel (CUDA) or the plain
    version (CPU); ``table`` is a float32 tensor on the blocks' device."""
    if not blocks.is_cuda:
        return apply_block_matrix(blocks, table, idx)
    lead = blocks.shape[:-3]
    b, c = blocks.shape[-3], blocks.shape[-1]
    m = math.prod(lead)
    out = apply_block_matrix_cuda(
        blocks.float().reshape(m, b, b, c).contiguous(), table,
        idx.reshape(m).to(torch.int32).contiguous())
    return out.reshape(blocks.shape)


class _BlockMatrix(torch.autograd.Function):
    """Linear in ``blocks``: the VJP is the same transform with T^T."""

    @staticmethod
    def forward(ctx, blocks, table, table_t, idx):
        ctx.save_for_backward(table_t, idx)
        return _transform(blocks, table, idx)

    @staticmethod
    def backward(ctx, grad):
        table_t, idx = ctx.saved_tensors
        return _transform(grad.contiguous(), table_t, idx), None, None, None


def apply_block_matrix_fast(blocks: torch.Tensor, table, idx: torch.Tensor) -> torch.Tensor:
    """``T[idx] @ X @ T[idx].T`` per block of ``(..., b, b, C)`` blocks,
    float32 out. ``table`` is a host-side ``(L, b, b)`` array. The kernel
    runs on CUDA tensors, the plain version on CPU tensors; differentiable
    in ``blocks``."""
    table_np = np.asarray(table, np.float64)
    dev = blocks.device
    t = torch.as_tensor(table_np, dtype=torch.float32).to(dev)
    t_t = torch.as_tensor(np.ascontiguousarray(np.swapaxes(table_np, -1, -2)),
                          dtype=torch.float32).to(dev)
    return _BlockMatrix.apply(blocks, t, t_t, idx)
