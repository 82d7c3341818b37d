"""Port parity: the per-block transform on frames (``apply_table_to_frames``),
which the degrade functions, the per-block Lanczos restorers and the
unsharp mask call. On the CPU it is the plain composition (split into
blocks, the plain transform, the unsharp combine, combine, round and
clip); here it is held to the JAX stage functions on the same numpy inputs
at small sizes, for b = 8 and 16 and C = 1, 3 and 4. On a CUDA tensor the
same call is one launch of ``csrc/block_transform.cu``; the ``gpu``-marked
tests hold that to this plain version on a card.

Tolerances: float32 frames ``atol=1e-4`` on 0-255 values (two products of
at most 16 float32 terms each, summed in another order; the unsharp
combine scales that by at most 6, hence ``6e-4`` there); uint8 frames at
most 1 LSB, on at most 0.1% of the pixels (a value within that distance of
a .5 tie may round the other way).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.core import blocks as jblocks
from elvis_tpu.degrade import adaptive as jadaptive
from elvis_tpu.kernels import block_transform as jbt
from elvis_tpu.restore import lanczos as jlanczos
from elvis_tpu.restore import unsharp as junsharp
from elvis_tpu_torch.core.blocks import split_into_blocks
from elvis_tpu_torch.degrade import adaptive as tadaptive
from elvis_tpu_torch.kernels import block_transform as tbt
from elvis_tpu_torch.restore import lanczos as tlanczos
from elvis_tpu_torch.restore import unsharp as tunsharp

ATOL = 1e-4
MAX_DIFF_SHARE = 1e-3
SIZES = [(32, 48), (48, 40)]  # with b = 16: 32 x 48 only (48 x 40 has no whole blocks)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _frames(rng, h, w, c, dtype):
    x = rng.integers(0, 256, (2, h, w, c))
    if dtype == "uint8":
        return x.astype(np.uint8)
    return (x + rng.random(x.shape)).astype(np.float32)


def _hold(got, want, dtype, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.dtype(dtype)
    if dtype == "uint8":
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= MAX_DIFF_SHARE
    else:
        np.testing.assert_allclose(got, want, atol=atol)


def _cases():
    for b in (8, 16):
        for h, w in SIZES:
            if h % b or w % b:
                continue
            for c in (1, 3, 4):
                yield pytest.param(b, h, w, c, id=f"b{b}-{h}x{w}-c{c}")


CASES = list(_cases())


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_downsample_matches_jax(b, h, w, c, dtype):
    rng = np.random.default_rng(b + h + c)
    frames = _frames(rng, h, w, c, dtype)
    scores = rng.random((2, h // b, w // b)).astype(np.float32)
    want, levels = jadaptive.adaptive_downsample(jnp.asarray(frames), jnp.asarray(scores), b)
    got = tbt.apply_table_to_frames(torch.from_numpy(frames),
                                    tbt.resample_matrix_table(b, "linear"),
                                    torch.from_numpy(np.asarray(levels)), b)
    _hold(got, want, dtype)
    whole, lv = tadaptive.adaptive_downsample(torch.from_numpy(frames), torch.from_numpy(scores), b)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(levels))
    assert torch.equal(whole, got)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_blur_matches_jax(b, h, w, c, dtype):
    rng = np.random.default_rng(2 * b + h + c)
    frames = _frames(rng, h, w, c, dtype)
    scores = rng.random((2, h // b, w // b)).astype(np.float32)
    want, rounds = jadaptive.adaptive_blur(jnp.asarray(frames), jnp.asarray(scores), b, 10)
    got = tbt.apply_table_to_frames(torch.from_numpy(frames), tbt.blur_matrix_table(b, 10),
                                    torch.from_numpy(np.asarray(rounds)), b)
    _hold(got, want, dtype)
    whole, _ = tadaptive.adaptive_blur(torch.from_numpy(frames), torch.from_numpy(scores), b, 10)
    assert torch.equal(whole, got)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_downsample_scale_matches_jax(b, h, w, c, dtype):
    rng = np.random.default_rng(3 * b + h + c)
    frames = _frames(rng, h, w, c, dtype)
    importance = rng.random((2, h // b, w // b)).astype(np.float32)
    want, smap = jadaptive.adaptive_downsample_scale(jnp.asarray(frames),
                                                     jnp.asarray(importance), b, 4)
    got, tmap = tadaptive.adaptive_downsample_scale(torch.from_numpy(frames),
                                                    torch.from_numpy(importance), b, 4)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(smap))
    _hold(got, want, dtype)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_lanczos_matches_jax(b, h, w, c, dtype):
    rng = np.random.default_rng(4 * b + h + c)
    frames = _frames(rng, h, w, c, dtype)
    levels = rng.integers(0, int(np.log2(b)) + 1, (2, h // b, w // b)).astype(np.int32)
    want = jlanczos.restore_downsample_lanczos(jnp.asarray(frames), jnp.asarray(levels), b)
    got = tbt.apply_table_to_frames(torch.from_numpy(frames),
                                    tbt.resample_matrix_table(b, "lanczos4"),
                                    torch.from_numpy(levels), b)
    _hold(got, want, dtype)
    assert torch.equal(tlanczos.restore_downsample_lanczos(torch.from_numpy(frames),
                                                           torch.from_numpy(levels), b), got)
    scales = rng.integers(0, 5, levels.shape).astype(np.int32)
    want = jlanczos.restore_downsample_scale_lanczos(jnp.asarray(frames), jnp.asarray(scales), b, 4)
    got = tlanczos.restore_downsample_scale_lanczos(torch.from_numpy(frames),
                                                    torch.from_numpy(scales), b, 4)
    _hold(got, want, dtype)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_unsharp_matches_jax_and_keeps_level0(b, h, w, c, dtype):
    rng = np.random.default_rng(5 * b + h + c)
    frames = _frames(rng, h, w, c, dtype)
    rounds = rng.integers(0, 11, (2, h // b, w // b)).astype(np.int32)
    rounds[0, 0, 0] = 0
    want = junsharp.restore_blur_unsharp(jnp.asarray(frames), jnp.asarray(rounds), b, 10)
    table = tunsharp._unsharp_blur_table(b, 10)
    got = tbt.apply_table_to_frames(torch.from_numpy(frames), table, torch.from_numpy(rounds), b,
                                    amount=0.5 * np.arange(11, dtype=np.float32))
    _hold(got, want, dtype, atol=6 * ATOL)
    assert torch.equal(tunsharp.restore_blur_unsharp(torch.from_numpy(frames),
                                                     torch.from_numpy(rounds), b, 10), got)
    keep = np.repeat(np.repeat(rounds == 0, b, axis=-1), b, axis=-2)[..., None]
    np.testing.assert_array_equal(np.where(keep, got.numpy(), 0), np.where(keep, frames, 0))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("with_amount", [False, True])
def test_out_of_range_levels_wrap_then_clamp(dtype, with_amount):
    """Levels {-1, -L-1, L, L+5} beside in-range ones: the frame function
    reads the table as the JAX reference's ``table[idx]`` does, and with an
    amount vector it reads that by the same wrapped and clamped level."""
    rng = np.random.default_rng(9)
    b, ell = 8, 11
    table = jbt.blur_matrix_table(b, 10)
    frames = _frames(rng, 16, 32, 3, dtype)
    odd = np.array([-1, -ell - 1, ell, ell + 5, 0, ell - 1, 1, -ell], np.int32).reshape(2, 2, 2)
    odd = np.concatenate([odd, odd[..., ::-1]], axis=-1)  # (2, 2, 4)
    same = np.where(odd < 0, odd + ell, odd).clip(0, ell - 1).astype(np.int32)
    amount = 0.5 * np.arange(ell, dtype=np.float32) if with_amount else None
    got = tbt.apply_table_to_frames(torch.from_numpy(frames), table, torch.from_numpy(odd), b,
                                    amount=amount)
    ref = tbt.apply_table_to_frames(torch.from_numpy(frames), table, torch.from_numpy(same), b,
                                    amount=amount)
    assert torch.equal(got, ref)
    if not with_amount:
        blocks = jblocks.split_into_blocks(jnp.asarray(frames).astype(jnp.float32), b)
        want = jblocks.combine_blocks(jbt.apply_block_matrix(
            blocks, jnp.asarray(table, jnp.float32), jnp.asarray(odd)))
        want = jadaptive._finalize(jnp.asarray(frames).dtype, want)
        _hold(got, want, dtype)


def test_leading_dimensions_and_other_types():
    """(T, N, H, W, C) frames with a (T, N, By, Bx) map; float64 and int16
    frames come back in their own type, integers rounded and clipped."""
    rng = np.random.default_rng(1)
    table = tbt.resample_matrix_table(8, "linear")
    frames = _frames(rng, 16, 24, 3, "float32").reshape(2, 1, 16, 24, 3)
    levels = torch.from_numpy(rng.integers(0, 4, (2, 1, 2, 3)).astype(np.int32))
    got = tbt.apply_table_to_frames(torch.from_numpy(frames), table, levels, 8)
    flat = tbt.apply_table_to_frames(torch.from_numpy(frames[:, 0]), table, levels[:, 0], 8)
    assert got.shape == frames.shape and torch.equal(got[:, 0], flat)
    as64 = tbt.apply_table_to_frames(torch.from_numpy(frames).double(), table, levels, 8)
    assert as64.dtype == torch.float64 and torch.equal(as64.float(), got)
    as16 = tbt.apply_table_to_frames(torch.from_numpy(frames).to(torch.int16), table, levels, 8)
    want = tbt.apply_table_to_frames(torch.from_numpy(frames).to(torch.uint8), table, levels, 8)
    assert as16.dtype == torch.int16 and torch.equal(as16, want.to(torch.int16))
    with pytest.raises(ValueError, match="not divisible"):
        tbt.apply_table_to_frames(torch.zeros((1, 12, 24, 3)), table, levels[0], 8)


def test_gradient_through_frames_matches_jax():
    rng = np.random.default_rng(3)
    frames = _frames(rng, 16, 24, 3, "float32")
    rounds = rng.integers(0, 11, (2, 2, 3)).astype(np.int32)
    table = jbt.blur_matrix_table(8, 10)

    def jloss(x):
        out = jbt.apply_block_matrix_fast(jblocks.split_into_blocks(x, 8), table,
                                          jnp.asarray(rounds))
        return jnp.sum(jblocks.combine_blocks(out) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(frames)))
    x = torch.from_numpy(frames).requires_grad_(True)
    (tbt.apply_table_to_frames(x, table, torch.from_numpy(rounds), 8) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-3, atol=1e-2)


def test_tables_are_uploaded_once_per_table_and_device():
    """Two calls with tables of equal content make one device tensor; the
    transpose is made when a backward first asks for it, and the backward
    still matches autograd of the plain version."""
    rng = np.random.default_rng(4)
    table = tbt.blur_matrix_table(8, 7).copy()  # a table no other test has used
    blocks = (rng.random((5, 8, 8, 3)) * 255).astype(np.float32)
    idx = torch.from_numpy(rng.integers(0, 8, (5,)).astype(np.int32))
    before = tbt.TABLE_UPLOADS["cpu"]
    first = tbt.apply_block_matrix_fast(torch.from_numpy(blocks), table, idx)
    assert tbt.TABLE_UPLOADS["cpu"] == before + 1
    again = tbt.apply_block_matrix_fast(torch.from_numpy(blocks), table.copy(), idx)
    assert tbt.TABLE_UPLOADS["cpu"] == before + 1 and torch.equal(first, again)
    assert tbt.device_table(table, "cpu") is tbt.device_table(table.copy(), "cpu")
    x = torch.from_numpy(blocks).requires_grad_(True)
    (tbt.apply_block_matrix_fast(x, table, idx) ** 2).sum().backward()
    assert tbt.TABLE_UPLOADS["cpu"] == before + 2  # the transpose, once
    x2 = torch.from_numpy(blocks).requires_grad_(True)
    (tbt.apply_block_matrix_fast(x2, table, idx) ** 2).sum().backward()
    assert tbt.TABLE_UPLOADS["cpu"] == before + 2
    xr = torch.from_numpy(blocks).requires_grad_(True)
    (tbt.apply_block_matrix(xr, torch.as_tensor(table, dtype=torch.float32), idx) ** 2
     ).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(tbt.device_table(table, "cpu", transpose=True).numpy(),
                                  np.swapaxes(table, -1, -2).astype(np.float32))


def test_split_views_are_recognised_by_their_strides():
    """The kernel takes a ``split_into_blocks`` view of contiguous frames
    by its strides; anything else is copied into block layout."""
    frames = torch.arange(2 * 16 * 24 * 3, dtype=torch.float32).reshape(2, 16, 24, 3)
    blocks = split_into_blocks(frames, 8)
    back = tbt._frames_of(blocks)
    assert back is not None and back.data_ptr() == frames.data_ptr() and torch.equal(back, frames)
    assert tbt._frames_of(split_into_blocks(frames[0], 8)).shape == (1, 16, 24, 3)
    five = split_into_blocks(frames.reshape(1, 2, 16, 24, 3), 8)
    assert tbt._frames_of(five).shape == (2, 16, 24, 3)
    assert tbt._frames_of(blocks.contiguous()) is None
    assert tbt._frames_of(blocks.reshape(-1, 8, 8, 3)) is None
    assert tbt._frames_of(split_into_blocks(frames[:, :, :16], 8)) is None
    assert tbt._frames_of(split_into_blocks(frames[..., :2], 8)) is None


def test_cuda_frame_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises and counts no
    launch."""
    before = tbt.LAUNCHES["block_transform"]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tbt.apply_table_to_frames_cuda(
            torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
            torch.as_tensor(tbt.resample_matrix_table(8, "linear"), dtype=torch.float32),
            torch.zeros((1, 1, 1), dtype=torch.int32), 8)
    tbt.apply_table_to_frames(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                              tbt.resample_matrix_table(8, "linear"),
                              torch.zeros((1, 1, 1), dtype=torch.int32), 8)
    assert tbt.LAUNCHES["block_transform"] == before


@pytest.mark.parametrize("b,c,in_size,out_size,bx", [
    (8, 3, 1, 1, 240), (8, 3, 4, 4, 240), (8, 3, 1, 4, 240), (8, 1, 1, 1, 240),
    (8, 4, 1, 1, 240), (16, 3, 1, 1, 120), (16, 1, 4, 4, 120), (8, 3, 1, 1, 5),
    (8, 3, 1, 1, 13), (16, 4, 4, 4, 3), (8, 7, 1, 1, 240)])
def test_frame_tiles_fit_and_stay_aligned(b, c, in_size, out_size, bx):
    """The tile the wrapper picks for a frame row of ``bx`` blocks: within
    the shared-memory budget, rows with a pitch of an odd number of 16-byte
    units, and where the frame's rows are 16-byte aligned every tile row is,
    the short last tile's too."""
    for ell in (1, 4, 11, 16):
        g = tbt._group_size(b, c, ell, frame=True, in_size=in_size, out_size=out_size, bx=bx)
        assert 1 <= g <= bx
        smem = tbt._transform_smem_bytes(b, c, ell, g, frame=True, in_size=in_size,
                                         out_size=out_size)
        assert smem <= tbt._SMEM_BUDGET
        for size in (in_size, out_size):
            pitch = tbt._pitch_bytes(g * b * c * size)
            assert pitch >= g * b * c * size and pitch % 16 == 0 and (pitch // 16) % 2 == 1
            if (bx * b * c * size) % 16 == 0:
                assert (g * b * c * size) % 16 == 0
                assert ((bx % g) * b * c * size) % 16 == 0
