"""Per-block matrix transforms (port of ``elvis_tpu.kernels.block_transform``).

Every per-block separable op of the degradation and restore paths is
``T[idx] @ X @ T[idx].T`` per block and channel, with T gathered from a
small ``(L, b, b)`` host table by each block's level: ``R_l = Up_l @ Down_l``
for the adaptive downsample, ``B^r`` for r within-block blur rounds.

  * ``conv_matrix_reflect101`` / ``blur_matrix_table`` /
    ``resample_matrix_table`` — the host tables (numpy, float64);
  * ``apply_block_matrix`` — the plain PyTorch version (gather + two
    einsums). The CPU path, and the comparison target on the card;
  * ``apply_table_to_frames`` — what the degrade and restore functions
    call: frames in, frames out, in the frames' own type. On CUDA tensors
    it is one launch of the hand-written CUDA kernel
    ``csrc/block_transform.cu`` (which replaces the TPU kernel
    ``apply_block_matrix_pallas_kron``) on the frames as they lie in
    memory: the split into blocks and the combine are the kernel's
    addressing, the uint8 cast, the round-and-clip and the optional unsharp
    combine its prologue and epilogue. On CPU tensors it is the plain
    composition of ``split_into_blocks``, ``apply_block_matrix``,
    ``combine_blocks`` and the rounding;
  * ``apply_table_to_frames_cuda`` / ``apply_block_matrix_cuda`` — that
    kernel's two layouts (frames, or an ``(M, b, b, C)`` array of float32
    blocks), on device tensors. CUDA tensors only;
  * ``apply_block_matrix_batched_cuda`` — the hand-written CUDA kernel
    ``csrc/block_transform_batched.cu``, replacing the TPU kernel
    ``apply_block_matrix_pallas``: the batched-small-matrix form, one tile
    of blocks per CTA transformed in place. Same contract as
    ``apply_block_matrix_cuda``, CUDA tensors only. Like its TPU
    counterpart it is a public function with no caller inside the package;
  * ``apply_block_matrix_fast`` — blocks in, float32 out, differentiable:
    an autograd function whose forward and backward (the same transform
    with T^T) go through the first kernel on CUDA tensors (by the strides
    of the view it is given, where that is a split of contiguous frames)
    and through the plain version on CPU tensors;
  * ``device_table`` — the float32 device copy of a host table, made once
    per table content and device (``TABLE_UPLOADS`` counts the uploads).

Both kernels share their arithmetic (``csrc/block_transform_core.cuh``: a
sub-warp of b lanes per ``(b, b)`` matrix, operands in registers). One
plain version serves both. All read a level as indexing the table on the
host does in the JAX package: a negative level wraps once (``l + L``), and
what is still outside ``[0, L)`` is clamped.

``LAUNCHES["block_transform"]`` and ``LAUNCHES["block_transform_batched"]``
count the kernels' launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
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
    "apply_block_matrix_batched_cuda",
    "apply_block_matrix_fast",
    "apply_table_to_frames",
    "apply_table_to_frames_cuda",
    "device_table",
    "TABLE_UPLOADS",
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
    ``(...,)`` int -> ``T[idx] @ X @ T[idx].T`` per block, float32. A
    negative level wraps once, the rest is clamped to ``[0, L)``."""
    table = torch.as_tensor(table, dtype=torch.float32, device=blocks.device)
    levels = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + levels, idx).clamp(0, levels - 1)
    t = table[idx]
    x = blocks.float()
    with full_fp32():
        y = torch.einsum("...ij,...jkc->...ikc", t, x)
        return torch.einsum("...lk,...ikc->...ilc", t, y)


_MAX_LEVELS = 16
_SMEM_LIMIT = 232448        # bytes one CTA may opt in to on Hopper (227 KB)
# Per CTA of the transform kernel: two fit on one SM. Full trips of the
# sub-warps matter more than a third CTA (8 float32 blocks of b = 16 are a
# 24 KB tile and 108 KB a CTA, and a third faster than 4 blocks in 70 KB).
_SMEM_BUDGET = 113 * 1024
_TILE_BYTES = 24 * 1024     # cap on one staged input tile of the transform kernel
_BATCHED_TILE_BYTES = 24 * 1024  # the batched kernel's one tile of blocks per CTA


def _threads(b: int) -> int:
    """Threads per CTA of both kernels (``CoreShape<B>::kThreads``)."""
    return 256 if b == 8 else 128


def _channels_together(c: int) -> int:
    """Channels of a block that one sub-warp of the transform kernel
    transforms on one read of T (the kernel's ``kCB``)."""
    return c if c in (1, 3, 4) else 1


def _pitch_bytes(row_bytes: int) -> int:
    """Bytes between the rows of a staged tile: an odd number of 16-byte
    units, so that a column of the tile spreads over the banks."""
    return (((row_bytes + 15) // 16) | 1) * 16


def _transform_smem_bytes(b: int, c: int, levels: int, group: int, *, frame: bool = False,
                          in_size: int = 4, out_size: int = 4) -> int:
    """Dynamic shared memory of one CTA of ``csrc/block_transform.cu``: the
    padded table, the amounts, the sub-warps' scratch, two sets of levels,
    two input tiles and one output tile."""
    rowlen = group * b * c if frame else b * c
    rows = b if frame else group * b
    fixed = (levels * (b * b + 4) + _MAX_LEVELS
             + _threads(b) * (b + 1) * _channels_together(c) + 2 * ((group + 3) & ~3)) * 4
    return fixed + rows * (2 * _pitch_bytes(rowlen * in_size) + _pitch_bytes(rowlen * out_size))


def _trip_cost(group: int, bx: int, c: int, ksub: int) -> float:
    """Trips of the sub-warps over a block row of ``bx`` blocks cut into
    tiles of ``group``, over the trips the row's units of work (``c`` a
    block) need at least."""
    full, last = divmod(bx, group)
    trips = full * -(-group * c // ksub) + -(-last * c // ksub)
    return trips * ksub / (bx * c)


@functools.lru_cache(maxsize=256)
def _group_size(b: int, c: int, levels: int, *, frame: bool = False, in_size: int = 4,
                out_size: int = 4, bx: "int | None" = None) -> int:
    """Blocks per tile of the transform kernel: the group whose matrices
    fill the sub-warps' trips best (the largest such), among those whose
    input tile stays under ``_TILE_BYTES`` and whose CTA stays under
    ``_SMEM_BUDGET``; at least one block if that fits the card at all. In
    frame layout a group is a multiple of what keeps every tile row a
    multiple of 16 bytes, where the frame's width allows that. 0 = nothing
    fits."""
    ksub = _threads(b) // b
    align = 1
    if frame:
        align = max(16 // math.gcd(16, b * c * size) for size in (in_size, out_size))
        if bx is not None and bx % align:
            align = 1  # rows of this width are not 16-byte aligned anyway
    best, best_cost = 0, math.inf
    top = bx if bx is not None else _TILE_BYTES // (b * b * c * in_size) + align
    for group in range(align, max(top, align) + 1, align):
        smem = _transform_smem_bytes(b, c, levels, group, frame=frame, in_size=in_size,
                                     out_size=out_size)
        small = smem <= _SMEM_BUDGET and group * b * b * c * in_size <= _TILE_BYTES
        if not small and (best or smem > _SMEM_LIMIT):
            break
        cost = _trip_cost(group, bx if bx is not None else group,
                          c // _channels_together(c), ksub)
        if cost <= best_cost + 1e-9:
            best, best_cost = group, cost
    return best


@functools.lru_cache(maxsize=256)
def _batched_group_size(b: int, c: int, levels: int = _MAX_LEVELS) -> int:
    """Blocks per CTA of the batched kernel: one tile, transformed in
    place, beside the table (padded to b*b + 4 floats per entry) and the
    sub-warps' scratch, within the 48 KB a launch may take without opting
    in to more; among the groups that fit, the largest that fills the
    sub-warps' trips best."""
    ksub = _threads(b) // b
    room = 48 * 1024 - (levels * (b * b + 4) + _threads(b) * (b + 1)) * 4
    top = min(_BATCHED_TILE_BYTES, room) // (4 * b * b * c)
    best, best_cost = 0, math.inf
    for group in range(1, top + 1):
        cost = _trip_cost(group, group, c, ksub)
        if cost <= best_cost + 1e-9:
            best, best_cost = group, cost
    return best


_ARGTYPES = {
    "block_transform": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p],
    "block_transform_batched": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """The C entry point ``elvis_<name>`` of ``csrc/<name>.cu``."""
    from elvis_tpu_torch.kernels import _build

    fn = getattr(_build.load(name), f"elvis_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


_PIXEL_SIZE = {torch.uint8: 1, torch.float32: 4}  # what the transform kernel reads and writes
_PIXEL_TYPES = tuple(_PIXEL_SIZE)


def _check_operands(name: str, x: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                    b: int, in_types=(torch.float32,)) -> None:
    """What both kernels ask of their operands, whatever the layout of x."""
    if not (x.is_cuda and table.is_cuda and idx.is_cuda):
        raise ValueError(f"the {name} kernel takes CUDA tensors only")
    if not (x.device == table.device == idx.device):
        raise ValueError("the input, table and idx must lie on one device")
    if x.dtype not in in_types or table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"the input must be {' or '.join(str(t) for t in in_types)}, the table "
                        f"float32 and idx int32, got {x.dtype}, {table.dtype}, {idx.dtype}")
    if b not in (8, 16):
        raise ValueError(f"block size {b} not supported (8 or 16)")
    if (table.dim() != 3 or tuple(table.shape[1:]) != (b, b)
            or not 1 <= table.shape[0] <= _MAX_LEVELS):
        raise ValueError(f"table must be (L, {b}, {b}) with 1 <= L <= {_MAX_LEVELS}, "
                         f"got {tuple(table.shape)}")
    if not (x.is_contiguous() and table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the input, table and idx must be contiguous")


def _launch_transform(x: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                      amount: "torch.Tensor | None", out_dtype: torch.dtype, *, frame: bool,
                      b: int, group: "int | None" = None, max_ctas: int = 0) -> torch.Tensor:
    """Launch ``csrc/block_transform.cu`` on checked operands: ``x`` is
    ``(N, H, W, C)`` frames with an ``(N, By, Bx)`` map (``frame``) or
    ``(M, b, b, C)`` blocks with an ``(M,)`` map. Counts the launch; raises
    on a failed one. ``group`` and ``max_ctas`` override the tile size and
    cap the grid: for the card-only tests and the tile sweep, no caller in
    the package sets them."""
    c = x.shape[-1]
    levels = table.shape[0]
    if frame:
        rows, bx, row_stride = x.shape[0] * (x.shape[1] // b), x.shape[2] // b, x.shape[2] * c
    else:
        rows, bx, row_stride = 1, x.shape[0], 0
    sizes = dict(frame=frame, in_size=_PIXEL_SIZE[x.dtype], out_size=_PIXEL_SIZE[out_dtype])
    if group is None:
        group = _group_size(b, c, levels, bx=bx if frame else None, **sizes)
    if group < 1 or _transform_smem_bytes(b, c, levels, min(group, max(bx, 1)),
                                          **sizes) > _SMEM_LIMIT:
        raise ValueError(f"{c} channels do not fit the kernel's shared-memory tile")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = _kernel_fn("block_transform")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), table.data_ptr(), idx.data_ptr(),
                 None if amount is None else amount.data_ptr(), rows, bx, row_stride,
                 int(frame), b, c, levels, int(x.dtype == torch.uint8),
                 int(out_dtype == torch.uint8), group, max_ctas, stream)
        LAUNCHES["block_transform"] += 1
    if err != 0:
        raise RuntimeError(f"block_transform kernel launch failed: CUDA error {err}")
    return out


def apply_block_matrix_cuda(blocks: torch.Tensor, table: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel in block layout: blocks ``(M, b, b, C)`` float32,
    table ``(L, b, b)`` float32, idx ``(M,)`` int32, all contiguous on one
    CUDA device; b in {8, 16}, 1 <= L <= 16. Returns a new ``(M, b, b, C)``
    float32."""
    if blocks.dim() != 4 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (M, b, b, C), got {tuple(blocks.shape)}")
    m, b = blocks.shape[:2]
    _check_operands("block_transform", blocks, table, idx, b)
    if tuple(idx.shape) != (m,):
        raise ValueError(f"idx must be ({m},), got {tuple(idx.shape)}")
    return _launch_transform(blocks, table, idx, None, torch.float32, frame=False, b=b)


def apply_table_to_frames_cuda(frames: torch.Tensor, table: torch.Tensor, levels: torch.Tensor,
                               block_size: int, amount: "torch.Tensor | None" = None,
                               out_dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """The CUDA kernel in frame layout: frames ``(N, H, W, C)`` uint8 or
    float32, table ``(L, b, b)`` float32, levels ``(N, H/b, W/b)`` int32,
    amount ``(L,)`` float32 or None, all contiguous on one CUDA device.
    One launch reads the frames as they lie and writes frames of
    ``out_dtype`` (default: the input's; uint8 is rounded half-to-even and
    clipped to [0, 255]). With ``amount`` each block comes back as
    ``clip((1 + a) X - a T X T^T, 0, 255)`` with ``a = amount[level]``, and
    as X itself where ``a <= 0``."""
    b = block_size
    out_dtype = frames.dtype if out_dtype is None else out_dtype
    _check_operands("block_transform", frames, table, levels, b, _PIXEL_TYPES)
    if out_dtype not in _PIXEL_TYPES or (frames.dtype, out_dtype) == (torch.float32, torch.uint8):
        raise TypeError(f"{frames.dtype} frames cannot come back as {out_dtype}")
    if frames.dim() != 4:
        raise ValueError(f"frames must be (N, H, W, C), got {tuple(frames.shape)}")
    n, h, w, _ = frames.shape
    if h % b or w % b:
        raise ValueError(f"Frame {h}x{w} not divisible by block_size={b}")
    if tuple(levels.shape) != (n, h // b, w // b):
        raise ValueError(f"levels must be {(n, h // b, w // b)}, got {tuple(levels.shape)}")
    if amount is not None:
        if out_dtype != frames.dtype:
            raise TypeError("with amount the frames come back in their own type")
        if not (amount.is_cuda and amount.device == frames.device and amount.is_contiguous()
                and amount.dtype == torch.float32 and tuple(amount.shape) == (table.shape[0],)):
            raise ValueError(f"amount must be a contiguous float32 ({table.shape[0]},) tensor "
                             "on the frames' device")
    return _launch_transform(frames, table, levels, amount, out_dtype, frame=True, b=b)


def apply_block_matrix_batched_cuda(blocks: torch.Tensor, table: torch.Tensor,
                                    idx: torch.Tensor) -> torch.Tensor:
    """The batched-small-matrix CUDA kernel: the contract of
    ``apply_block_matrix_cuda``, computed by ``csrc/block_transform_batched.cu``
    (one tile per CTA, transformed in place)."""
    name = "block_transform_batched"
    if blocks.dim() != 4 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (M, b, b, C), got {tuple(blocks.shape)}")
    m, b, _, c = blocks.shape
    _check_operands(name, blocks, table, idx, b)
    if tuple(idx.shape) != (m,):
        raise ValueError(f"idx must be ({m},), got {tuple(idx.shape)}")
    levels = table.shape[0]
    group = _batched_group_size(b, c, levels)
    if group < 1:
        raise ValueError(f"{c} channels do not fit the kernel's shared-memory tile")
    out = torch.empty_like(blocks)
    if m == 0:
        return out
    fn = _kernel_fn(name)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = fn(blocks.data_ptr(), table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 m, b, c, levels, group, stream)
        LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


# float32 device copies of host tables, by content and device: a path
# uploads each table once, not on every call
_DEVICE_TABLES: "dict[tuple, torch.Tensor]" = {}
TABLE_UPLOADS: "collections.Counter[str]" = collections.Counter()


def device_table(table, device, *, transpose: bool = False) -> torch.Tensor:
    """The float32 tensor of a host table on ``device`` (with its last two
    axes swapped if ``transpose``), made on first use and kept."""
    host = np.ascontiguousarray(np.asarray(table, np.float64))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (host.shape, host.tobytes(), str(device), transpose)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        if transpose:
            host = np.ascontiguousarray(np.swapaxes(host, -1, -2))
        hit = torch.as_tensor(host, dtype=torch.float32).to(device)
        if len(_DEVICE_TABLES) >= 256:
            _DEVICE_TABLES.clear()
        _DEVICE_TABLES[key] = hit
        TABLE_UPLOADS[str(device)] += 1
    return hit


def _frames_of(blocks: torch.Tensor) -> "torch.Tensor | None":
    """The contiguous ``(N, H, W, C)`` frames that ``blocks`` is the
    ``split_into_blocks`` view of, or None if it is not such a view."""
    if blocks.dim() < 5:
        return None
    n = blocks.dim() - 5
    x = blocks.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)  # (..., By, b, Bx, b, C)
    if not x.is_contiguous():
        return None
    *_, by, b, bx, _, c = x.shape
    return x.reshape(-1, by * b, bx * b, c)


def _transform(blocks: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(..., b, b, C)`` blocks through the kernel (CUDA) or the plain
    version (CPU), float32 out; ``table`` is a float32 tensor on the
    blocks' device. A view that ``split_into_blocks`` made of contiguous
    uint8 or float32 frames goes to the kernel by its strides (frame
    layout) and comes back as the same view of new frames; anything else is
    copied into block layout first."""
    if not blocks.is_cuda:
        return apply_block_matrix(blocks, table, idx)
    lead = blocks.shape[:-3]
    b, c = blocks.shape[-3], blocks.shape[-1]
    idx = idx.to(torch.int32).contiguous()
    frames = _frames_of(blocks) if blocks.dtype in _PIXEL_TYPES else None
    if frames is not None and tuple(idx.shape) == tuple(lead) and frames.numel():
        n, h, w, _ = frames.shape
        out = apply_table_to_frames_cuda(frames, table, idx.reshape(n, h // b, w // b), b,
                                         out_dtype=torch.float32)
        out = out.reshape(*lead[:-2], h // b, b, w // b, b, c)
        k = len(lead) - 2
        return out.permute(*range(k), k, k + 2, k + 1, k + 3, k + 4)
    m = math.prod(lead)
    out = apply_block_matrix_cuda(blocks.float().reshape(m, b, b, c).contiguous(), table,
                                  idx.reshape(m))
    return out.reshape(blocks.shape)


class _BlockMatrix(torch.autograd.Function):
    """Linear in ``blocks``: the VJP is the same transform with T^T."""

    @staticmethod
    def forward(ctx, blocks, table, idx, table_host):
        ctx.save_for_backward(idx)
        ctx.table_host = table_host
        return _transform(blocks, table, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        table_t = device_table(ctx.table_host, grad.device, transpose=True)
        return _transform(grad, table_t, idx), None, None, None


def apply_block_matrix_fast(blocks: torch.Tensor, table, idx: torch.Tensor) -> torch.Tensor:
    """``T[idx] @ X @ T[idx].T`` per block of ``(..., b, b, C)`` blocks,
    float32 out. ``table`` is a host-side ``(L, b, b)`` array; its device
    copy is made once per table and device (and the transpose only when a
    backward asks for it). The kernel runs on CUDA tensors, the plain
    version on CPU tensors; differentiable in ``blocks``."""
    return _BlockMatrix.apply(blocks, device_table(table, blocks.device), idx, table)


def _plain_table_to_frames(frames, table, levels, block_size, amount=None):
    """The plain version of ``apply_table_to_frames``: split into blocks,
    transform, (the unsharp combine,) put together, round and clip."""
    blocks = split_into_blocks(frames, block_size)
    out = apply_block_matrix_fast(blocks, table, levels)
    if amount is not None:
        amount = torch.as_tensor(np.asarray(amount, np.float32), device=frames.device)
        ell = amount.shape[0]
        lv = levels.long()
        lv = torch.where(lv < 0, lv + ell, lv).clamp(0, ell - 1)
        a = amount[lv][..., None, None, None]
        x = blocks.float()
        out = torch.where(a > 0, torch.clamp((1.0 + a) * x - a * out, 0, 255), x)
    out = combine_blocks(out)
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)


def apply_table_to_frames(frames: torch.Tensor, table, levels: torch.Tensor, block_size: int,
                          amount=None) -> torch.Tensor:
    """``T[level] @ X @ T[level].T`` on every block and channel of
    ``(..., H, W, C)`` frames; ``table`` is a host-side ``(L, b, b)`` array,
    ``levels`` an ``(..., H/b, W/b)`` integer map. Frames come back in
    their own type (integer types rounded half-to-even and clipped to
    [0, 255]). With a host-side ``amount`` ``(L,)`` each block comes back as
    ``clip((1 + a) X - a T X T^T, 0, 255)``, ``a = amount[level]``, and
    bit-exact where ``a <= 0``: the unsharp mask.

    On CUDA tensors it is ONE launch of ``csrc/block_transform.cu`` on the
    frames as they lie in memory (uint8 or float32; other types are cast to
    float32 first), with no cast, copy or rounding pass around it; a failed
    launch raises. On CPU tensors it is the plain version. Frames that
    require a gradient take the differentiable composition, which launches
    the same kernel."""
    if not frames.is_cuda or (frames.requires_grad and torch.is_grad_enabled()):
        return _plain_table_to_frames(frames, table, levels, block_size, amount)
    *lead, h, w, c = frames.shape
    if h % block_size or w % block_size:
        raise ValueError(f"Frame {h}x{w} not divisible by block_size={block_size}")
    x = frames if frames.dtype in _PIXEL_TYPES else frames.float()
    x = x.reshape(-1, h, w, c).contiguous()
    lv = levels.to(torch.int32).reshape(-1, h // block_size, w // block_size).contiguous()
    out = apply_table_to_frames_cuda(
        x, device_table(table, frames.device), lv, block_size,
        None if amount is None else device_table(amount, frames.device))
    out = out.reshape(frames.shape)
    if out.dtype != frames.dtype:
        if not frames.dtype.is_floating_point:
            out = torch.clamp(torch.round(out), 0, 255)
        out = out.to(frames.dtype)
    return out
