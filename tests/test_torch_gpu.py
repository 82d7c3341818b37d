"""Card-only checks of the port (marker ``gpu``): its two CUDA kernels (the
transform kernel in its block and frame layouts, and the batched kernel),
the NVC codec, the fills and the pipeline on the card against the CPU, the
halo functions and ``run_elvis`` on logical shards of the card, the
trainer's steps on the card against the CPU and against themselves, and
the dense library route of the transform against its kernel; then the
paths at full width (8 frames of 1080p): the main, blur and codec paths,
``run_elvis`` with every backend, the external encoders, PRESLEY, the
parallel layer, the trainers, the searches and the evaluators; E2FGVI-HQ's
deformable conv kernel and its ``e2fgvi_hq`` backend against the
benchmark's reference.

They skip where no CUDA device is present. This file imports no JAX, so
on a machine with a card and no JAX it runs without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerance: the kernel and the plain version both compute in float32
without TF32 and differ only in summation order, so ``atol=1e-3`` on 0-255
data (the JAX package's kernel tolerance). uint8 frames may differ by
1 LSB where a value lands within that distance of a .5 tie; on random data
that is rare, and the tests bound the share of such pixels.
"""

import math

import numpy as np
import pytest
import torch

ATOL = 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,table_kind,m", [(8, "resample", 5000), (8, "blur", 777),
                                            (16, "resample", 301), (16, "blur", 64)])
def test_kernel_matches_plain(b, table_kind, m):
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = (bt.resample_matrix_table(b, "linear") if table_kind == "resample"
             else bt.blur_matrix_table(b, 10))
    rng = np.random.default_rng(b + m)
    blocks = torch.as_tensor((rng.random((m, b, b, 3)) * 255).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, table.shape[0], (m,)).astype(np.int32), device=dev)
    t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    before = bt.LAUNCHES["block_transform"]
    got = bt.apply_block_matrix_cuda(blocks, t, idx)
    torch.cuda.synchronize()
    assert bt.LAUNCHES["block_transform"] == before + 1
    want = bt.apply_block_matrix(blocks, t, idx)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_kron_route_on_card_matches_the_kernel():
    """The dense route (``apply_block_matrix_kron``: one cuBLAS product over
    every level, then a gather) against the transform kernel, b=8, levels
    outside the table included; it launches no kernel of the port."""
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.resample_matrix_table(8, "linear")
    ell = table.shape[0]
    rng = np.random.default_rng(8)
    blocks = torch.as_tensor((rng.random((3000, 8, 8, 3)) * 255).astype(np.float32), device=dev)
    idx = rng.integers(0, ell, (3000,)).astype(np.int32)
    idx[:4] = [-1, -ell - 1, ell, ell + 5]
    idx = torch.as_tensor(idx, device=dev)
    before = dict(bt.LAUNCHES)
    got = bt.apply_block_matrix_kron(blocks, table, idx)
    torch.cuda.synchronize()
    assert dict(bt.LAUNCHES) == before
    want = bt.apply_block_matrix_cuda(blocks, torch.as_tensor(table, dtype=torch.float32,
                                                              device=dev), idx)
    assert got.shape == blocks.shape and (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_kernel_backward_matches_plain_autograd():
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.blur_matrix_table(8, 10)
    rng = np.random.default_rng(1)
    blocks = (rng.random((2, 3, 4, 8, 8, 3)) * 255).astype(np.float32)
    idx = torch.as_tensor(rng.integers(0, 11, (2, 3, 4)).astype(np.int32), device=dev)
    x = torch.as_tensor(blocks, device=dev).requires_grad_(True)
    (bt.apply_block_matrix_fast(x, table, idx) ** 2).sum().backward()
    xr = torch.as_tensor(blocks, device=dev).requires_grad_(True)
    t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    (bt.apply_block_matrix(xr, t, idx) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-3, atol=1e-2)


@pytest.mark.gpu
def test_wrapper_rejects_bad_input():
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    t = torch.as_tensor(bt.resample_matrix_table(8, "linear"), dtype=torch.float32, device=dev)
    x = torch.zeros((4, 8, 8, 3), device=dev)
    idx = torch.zeros((4,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        bt.apply_block_matrix_cuda(x.double(), t, idx)
    with pytest.raises(ValueError):
        bt.apply_block_matrix_cuda(torch.zeros((4, 4, 4, 3), device=dev), t, idx)
    with pytest.raises(ValueError):
        bt.apply_block_matrix_cuda(x.permute(0, 2, 1, 3), t, idx)


@pytest.mark.gpu
def test_adaptive_downsample_on_card_matches_cpu():
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.kernels import LAUNCHES

    dev = _cuda()
    rng = np.random.default_rng(0)
    frames = (rng.random((2, 48, 64, 3)) * 255).astype(np.uint8)
    scores = rng.random((2, 6, 8)).astype(np.float32)
    before = LAUNCHES["block_transform"]
    got, lv = adaptive_downsample(torch.as_tensor(frames, device=dev),
                                  torch.as_tensor(scores, device=dev), 8)
    assert LAUNCHES["block_transform"] == before + 1
    want, lv_cpu = adaptive_downsample(torch.from_numpy(frames), torch.from_numpy(scores), 8)
    assert torch.equal(lv.cpu(), lv_cpu)
    assert (got.cpu().int() - want.int()).abs().max().item() <= 1


def _table(bt, b, kind):
    if kind == "resample":
        return bt.resample_matrix_table(b, "linear")
    if kind == "blur":
        return bt.blur_matrix_table(b, 10)
    if kind == "unsharp":
        from elvis_tpu_torch.restore.unsharp import _unsharp_blur_table

        return _unsharp_blur_table(b, 10)
    return bt.resample_matrix_table(b, "lanczos4")


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("b,table_kind,m", [(8, "blur", 5000), (8, "unsharp", 777),
                                            (8, "lanczos", 33), (16, "resample", 301),
                                            (16, "unsharp", 7)])
def test_batched_kernel_matches_plain_and_first_kernel(b, table_kind, m, c):
    """The batched-small kernel against the plain version and against the
    first kernel, at the blur, unsharp and Lanczos tables; M covers a tail
    CTA, C the luma plane and a 4-channel tile."""
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = _table(bt, b, table_kind)
    rng = np.random.default_rng(b + m + c)
    blocks = torch.as_tensor((rng.random((m, b, b, c)) * 255).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, table.shape[0], (m,)).astype(np.int32), device=dev)
    t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    before = bt.LAUNCHES["block_transform_batched"]
    got = bt.apply_block_matrix_batched_cuda(blocks, t, idx)
    torch.cuda.synchronize()
    assert bt.LAUNCHES["block_transform_batched"] == before + 1
    assert (got - bt.apply_block_matrix(blocks, t, idx)).abs().max().item() <= ATOL
    assert (got - bt.apply_block_matrix_cuda(blocks, t, idx)).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["apply_block_matrix_cuda", "apply_block_matrix_batched_cuda"])
def test_kernels_wrap_then_clamp_out_of_range_levels(kernel):
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.blur_matrix_table(8, 10)
    ell = table.shape[0]
    idx = torch.tensor([-1, -ell - 1, ell, ell + 5, 0, ell - 1], dtype=torch.int32, device=dev)
    same = torch.tensor([ell - 1, 0, ell - 1, ell - 1, 0, ell - 1], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    blocks = torch.as_tensor((rng.random((6, 8, 8, 3)) * 255).astype(np.float32), device=dev)
    t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    got = getattr(bt, kernel)(blocks, t, idx)
    assert torch.equal(got, getattr(bt, kernel)(blocks, t, same))
    assert (got - bt.apply_block_matrix(blocks, t, idx)).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_batched_wrapper_rejects_bad_input():
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    t = torch.as_tensor(bt.resample_matrix_table(8, "linear"), dtype=torch.float32, device=dev)
    x = torch.zeros((4, 8, 8, 3), device=dev)
    idx = torch.zeros((4,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        bt.apply_block_matrix_batched_cuda(x, t, idx.long())
    with pytest.raises(ValueError):
        bt.apply_block_matrix_batched_cuda(torch.zeros((4, 4, 4, 3), device=dev), t, idx)
    with pytest.raises(ValueError):
        bt.apply_block_matrix_batched_cuda(x.permute(0, 2, 1, 3), t, idx)
    with pytest.raises(ValueError):
        bt.apply_block_matrix_batched_cuda(x, t.repeat(5, 1, 1), idx)  # L = 20
    with pytest.raises(ValueError):
        bt.apply_block_matrix_batched_cuda(x, t, idx[:3])


@pytest.mark.gpu
def test_blur_branch_on_card_matches_cpu():
    from elvis_tpu_torch.degrade import adaptive_blur
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.restore import restore_blur_unsharp, restore_downsample_lanczos

    dev = _cuda()
    rng = np.random.default_rng(0)
    frames = (rng.random((2, 48, 64, 3)) * 255).astype(np.uint8)
    scores = rng.random((2, 6, 8)).astype(np.float32)
    before = LAUNCHES["block_transform"]
    blurred, rounds = adaptive_blur(torch.as_tensor(frames, device=dev),
                                    torch.as_tensor(scores, device=dev), 8)
    sharp = restore_blur_unsharp(blurred, rounds, 8)
    lanczos = restore_downsample_lanczos(blurred, rounds.clamp(max=3), 8)
    assert LAUNCHES["block_transform"] == before + 3
    b_cpu, r_cpu = adaptive_blur(torch.from_numpy(frames), torch.from_numpy(scores), 8)
    assert torch.equal(rounds.cpu(), r_cpu)
    assert (blurred.cpu().int() - b_cpu.int()).abs().max().item() <= 1
    s_cpu = restore_blur_unsharp(blurred.cpu(), r_cpu, 8)
    l_cpu = restore_downsample_lanczos(blurred.cpu(), r_cpu.clamp(max=3), 8)
    assert (sharp.cpu().int() - s_cpu.int()).abs().max().item() <= 1
    assert (lanczos.cpu().int() - l_cpu.int()).abs().max().item() <= 1


def _frames(rng, shape, dtype, dev):
    """Random frames; uint8 ones in steps that make exact .5 ties common
    under the dyadic resample weights."""
    x = rng.integers(0, 256, shape)
    if dtype == torch.uint8:
        return torch.as_tensor(x.astype(np.uint8), device=dev)
    return torch.as_tensor((x + rng.random(shape)).astype(np.float32), device=dev)


def _hold_frames(got, want):
    """float32: ATOL; uint8: at most 1 LSB, on at most 0.1% of the pixels."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.uint8:
        diff = (got.cpu().int() - want.cpu().int()).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() <= 1e-3
    else:
        assert (got.cpu() - want.cpu()).abs().max().item() <= ATOL


# (H, W): 96 x 3 = 288 and 48 x 4 are multiples of 16 bytes as uint8, 40 x 3
# and 40 x 1 are not (the scalar path); as float32 every row is
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("with_amount", [False, True])
@pytest.mark.parametrize("b,h,w,c", [(8, 32, 96, 3), (8, 48, 40, 3), (8, 32, 48, 4),
                                      (8, 48, 40, 1), (16, 32, 96, 3), (16, 48, 80, 1),
                                      (16, 32, 48, 4), (8, 16, 24, 2)])
def test_frame_kernel_matches_plain(dtype, with_amount, b, h, w, c):
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = _table(bt, b, "unsharp" if with_amount else "resample")
    ell = table.shape[0]
    amount = 0.5 * np.arange(ell, dtype=np.float32) if with_amount else None
    rng = np.random.default_rng(b + h + w + c)
    frames = _frames(rng, (3, h, w, c), dtype, dev)
    levels = torch.as_tensor(rng.integers(0, ell, (3, h // b, w // b)).astype(np.int32),
                             device=dev)
    before = bt.LAUNCHES["block_transform"]
    got = bt.apply_table_to_frames(frames, table, levels, b, amount=amount)
    torch.cuda.synchronize()
    assert bt.LAUNCHES["block_transform"] == before + 1
    want = bt.apply_table_to_frames(frames.cpu(), table, levels.cpu(), b, amount=amount)
    _hold_frames(got, want)
    if with_amount:  # level-0 blocks come back bit-exact
        keep = (levels == 0).repeat_interleave(b, -1).repeat_interleave(b, -2)[..., None]
        assert bool(keep.any())
        assert torch.equal(torch.where(keep, got, 0), torch.where(keep, frames, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("group,max_ctas", [(None, 7), (4, 5), (3, 0), (1, 3), (100, 0)])
def test_frame_kernel_tiles_and_ctas(dtype, group, max_ctas):
    """Tile counts that do not divide the CTA count, short last tiles, a
    group that breaks the 16-byte alignment (3 x 24 bytes) and one larger
    than the block row."""
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.blur_matrix_table(8, 10)
    rng = np.random.default_rng(11)
    frames = _frames(rng, (3, 40, 176, 3), dtype, dev)  # 15 block rows of 22 blocks
    levels = torch.as_tensor(rng.integers(0, 11, (3, 5, 22)).astype(np.int32), device=dev)
    got = bt._launch_transform(frames, bt.device_table(table, dev), levels, None, dtype,
                               frame=True, b=8, group=group, max_ctas=max_ctas)
    torch.cuda.synchronize()
    _hold_frames(got, bt.apply_table_to_frames(frames.cpu(), table, levels.cpu(), 8))


@pytest.mark.gpu
def test_frame_kernel_uint8_ties_round_half_to_even():
    """Flat blocks of odd values through the level-1 resample (2 x 2 area
    means of equal values: exact) and pairs (v, v + 1) along x: every mean is
    an exact .5 tie, and the kernel rounds it as torch.round does."""
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.resample_matrix_table(8, "linear")
    v = torch.arange(0, 240, dtype=torch.uint8)
    row = torch.stack([v, v + 1], dim=1).reshape(-1)[:96]  # 96 = 12 blocks
    frames = row.view(1, 1, 96, 1).expand(2, 16, 96, 3).contiguous().to(dev)
    levels = torch.ones((2, 2, 12), dtype=torch.int32, device=dev)
    got = bt.apply_table_to_frames(frames, table, levels, 8)
    want = bt.apply_table_to_frames(frames.cpu(), table, levels.cpu(), 8)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_frame_kernel_wraps_then_clamps_out_of_range_levels():
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.blur_matrix_table(8, 10)
    ell = table.shape[0]
    odd = torch.tensor([-1, -ell - 1, ell, ell + 5, 0, ell - 1], dtype=torch.int32, device=dev)
    same = torch.tensor([ell - 1, 0, ell - 1, ell - 1, 0, ell - 1], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(5)
    frames = _frames(rng, (2, 8, 24, 3), torch.float32, dev)
    got = bt.apply_table_to_frames(frames, table, odd.view(2, 1, 3), 8)
    assert torch.equal(got, bt.apply_table_to_frames(frames, table, same.view(2, 1, 3), 8))
    want = bt.apply_table_to_frames(frames.cpu(), table, odd.cpu().view(2, 1, 3), 8)
    assert (got.cpu() - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_frame_wrapper_rejects_bad_input():
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    t = bt.device_table(bt.resample_matrix_table(8, "linear"), dev)
    frames = torch.zeros((2, 16, 32, 3), dtype=torch.uint8, device=dev)
    levels = torch.zeros((2, 2, 4), dtype=torch.int32, device=dev)
    before = bt.LAUNCHES["block_transform"]
    with pytest.raises(TypeError):
        bt.apply_table_to_frames_cuda(frames.to(torch.int16), t, levels, 8)
    with pytest.raises(TypeError):
        bt.apply_table_to_frames_cuda(frames.double(), t, levels, 8)
    with pytest.raises(TypeError):
        bt.apply_table_to_frames_cuda(frames, t, levels.long(), 8)
    with pytest.raises(TypeError):  # float32 frames do not come back as uint8
        bt.apply_table_to_frames_cuda(frames.float(), t, levels, 8, out_dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        bt.apply_table_to_frames_cuda(frames.cpu(), t.cpu(), levels.cpu(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        bt.apply_table_to_frames_cuda(frames.transpose(1, 2), t, levels, 8)
    with pytest.raises(ValueError, match="contiguous"):
        bt.apply_table_to_frames_cuda(frames[:, :, ::2], t, levels[:, :, ::2], 8)
    with pytest.raises(ValueError, match="not divisible"):
        bt.apply_table_to_frames_cuda(frames[:, :12].contiguous(), t, levels, 8)
    with pytest.raises(ValueError, match="not divisible"):
        bt.apply_table_to_frames_cuda(frames[:, :, :28].contiguous(), t, levels, 8)
    with pytest.raises(ValueError, match="levels must be"):
        bt.apply_table_to_frames_cuda(frames, t, levels[:, :1].contiguous(), 8)
    with pytest.raises(ValueError, match="amount"):
        bt.apply_table_to_frames_cuda(frames, t, levels, 8,
                                      amount=torch.zeros(3, device=dev))
    assert bt.LAUNCHES["block_transform"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_takes_a_split_view_by_its_strides(dtype):
    """apply_block_matrix_fast on the split view of contiguous frames: one
    launch in frame layout, float32 out, no copy into block layout; the
    backward matches autograd of the plain version."""
    from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = _cuda()
    table = bt.blur_matrix_table(8, 10)
    rng = np.random.default_rng(2)
    frames = _frames(rng, (2, 24, 48, 3), dtype, dev)
    idx = torch.as_tensor(rng.integers(0, 11, (2, 3, 6)).astype(np.int32), device=dev)
    blocks = split_into_blocks(frames, 8)
    assert bt._frames_of(blocks) is not None and bt._frames_of(blocks.contiguous()) is None
    before = bt.LAUNCHES["block_transform"]
    got = bt.apply_block_matrix_fast(blocks, table, idx)
    assert bt.LAUNCHES["block_transform"] == before + 1
    assert got.dtype == torch.float32 and got.shape == blocks.shape
    want = bt.apply_block_matrix(blocks, bt.device_table(table, dev), idx)
    assert (got - want).abs().max().item() <= ATOL
    assert combine_blocks(got).is_contiguous()
    if dtype == torch.float32:
        x = frames.clone().requires_grad_(True)
        (bt.apply_block_matrix_fast(split_into_blocks(x, 8), table, idx) ** 2).sum().backward()
        xr = frames.clone().requires_grad_(True)
        (bt.apply_block_matrix(split_into_blocks(xr, 8), bt.device_table(table, dev), idx)
         ** 2).sum().backward()
        torch.testing.assert_close(x.grad, xr.grad, rtol=1e-3, atol=1e-2)


@pytest.mark.gpu
def test_stages_launch_once_and_upload_each_table_once():
    from elvis_tpu_torch.degrade import (adaptive_blur, adaptive_downsample,
                                         adaptive_downsample_scale)
    from elvis_tpu_torch.kernels import block_transform as bt
    from elvis_tpu_torch.restore import (restore_blur_unsharp, restore_downsample_lanczos,
                                         restore_downsample_scale_lanczos)

    dev = _cuda()
    rng = np.random.default_rng(0)
    frames = torch.as_tensor((rng.random((2, 48, 64, 3)) * 255).astype(np.uint8), device=dev)
    scores = torch.as_tensor(rng.random((2, 6, 8)).astype(np.float32), device=dev)

    def run():
        counts = []
        for fn in (lambda: adaptive_downsample(frames, scores, 8)[0],
                   lambda: adaptive_downsample_scale(frames, scores, 8)[0],
                   lambda: adaptive_blur(frames, scores, 8)[0],
                   lambda: restore_downsample_lanczos(frames, (scores * 3).int(), 8),
                   lambda: restore_downsample_scale_lanczos(frames, (scores * 4).int(), 8),
                   lambda: restore_blur_unsharp(frames, (scores * 10).int(), 8)):
            before = bt.LAUNCHES["block_transform"]
            out = fn()
            counts.append(bt.LAUNCHES["block_transform"] - before)
            assert out.dtype == torch.uint8 and out.shape == frames.shape
        return counts

    assert run() == [1] * 6
    uploads = sum(bt.TABLE_UPLOADS.values())
    assert run() == [1] * 6
    assert sum(bt.TABLE_UPLOADS.values()) == uploads


def _codec_crop(n=3, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        base = 128 + 60 * np.sin(2 * np.pi * (xx + 3 * t) / 32) + 40 * np.cos(2 * np.pi * yy / 24)
        img = np.stack([base, np.roll(base, 3, axis=1), np.roll(base, -2, axis=0)], axis=-1)
        frames.append(np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8))
    return np.stack(frames)


def _psnr_u8(a, b):
    mse = ((a.double() - b.double()) ** 2).mean().item()
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [dict(gop=2), dict(multi_ref=True), dict(b_frames=True),
                                   dict(me_radius=12), dict(deblock=False, intra_pred=False)])
def test_codec_stream_decodes_alike_on_card_and_cpu(flags):
    """The same stream, made on either device, decodes on the card and on
    the CPU to frames within 1 LSB; an encode on the card decoded on the CPU
    has the PSNR of card-card within 0.01 dB."""
    from elvis_tpu_torch.codec.nvc import codec as nvc

    dev = _cuda()
    frames = _codec_crop()
    source = torch.from_numpy(frames)
    for made_on in ("cuda", "cpu"):
        stream = nvc.encode(frames, qp=28, device=made_on, **flags)
        on_card, fps = nvc.decode(stream, device=dev)
        on_cpu, _ = nvc.decode(stream, device="cpu")
        assert on_card.is_cuda and on_card.dtype == torch.uint8 and fps == 30.0
        assert (on_card.cpu().int() - on_cpu.int()).abs().max().item() <= 1
        assert abs(_psnr_u8(source, on_card.cpu()) - _psnr_u8(source, on_cpu)) <= 0.01
    # a tensor on the card encodes there without being asked
    assert nvc.encode(source.to(dev), qp=28, **flags) == nvc.encode(frames, qp=28, device=dev,
                                                                    **flags)


@pytest.mark.gpu
def test_codec_pinned_numbers_on_card():
    """The Qstep table and the bit model are the same numbers on the card."""
    from elvis_tpu_torch.codec.nvc import transform as tt

    dev = _cuda()
    qps = torch.arange(52)
    assert torch.equal(tt.qstep_from_qp(qps.to(dev)).cpu(), tt.qstep_from_qp(qps))
    mags = torch.arange(32768, dtype=torch.float32)
    bits = tt._level_bits(mags.to(dev)).cpu()
    assert torch.equal(bits, tt._level_bits(mags))
    levels = np.arange(32768, dtype=np.float64)
    model = np.where(levels > 0, 2.0 * np.ceil(np.log2(levels + 1.0)) + 2.0, 0.05)
    assert np.array_equal(bits.numpy(), model.astype(np.float32))  # 2*ceil(log2(l+1))+2


@pytest.mark.gpu
def test_codec_motion_prediction_is_bit_exact_on_card():
    """Half-pel prediction is one pixel or the mean of two or four: with
    TF32 off inside the package it is the same bits on the card, whatever
    the global switch says."""
    from elvis_tpu_torch.codec.nvc import transform as tt

    dev = _cuda()
    rng = np.random.default_rng(3)
    prev = torch.from_numpy((rng.random((64, 96)) * 255).astype(np.float32))
    mv2 = torch.from_numpy(rng.integers(-20, 21, (8, 12, 2)).astype(np.int32))
    want = tt._motion_predict(prev, mv2, reach=2)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tt._motion_predict(prev.to(dev), mv2.to(dev), reach=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(got.cpu(), want)


# --- the pipeline (run_elvis) and its new modules, card against CPU ---------

@pytest.mark.gpu
def test_lpips_on_card_matches_cpu():
    """The shipped LPIPS backbone in float32 with TF32 off: card and CPU
    within 1e-5 relative, whatever the global TF32 switch says."""
    from elvis_tpu_torch.metrics.perceptual import lpips_distance

    dev = _cuda()
    rng = np.random.default_rng(5)
    ref = (rng.random((3, 72, 104, 3)) * 255).astype(np.float32)
    dec = np.clip(ref + rng.normal(0, 12, ref.shape), 0, 255).astype(np.float32)
    want = lpips_distance(torch.from_numpy(ref), torch.from_numpy(dec))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = lpips_distance(torch.from_numpy(ref).to(dev), torch.from_numpy(dec).to(dev))
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_motion_hint_and_pde_fill_on_card_match_cpu():
    """The server's motion hint (quarter-pel ints) is the same on the card;
    the PDE fill within 1 LSB."""
    from elvis_tpu_torch.ops.motion import motion_hint
    from elvis_tpu_torch.restore.inpaint import restore_removal_diffusion

    dev = _cuda()
    rng = np.random.default_rng(6)
    tex = np.cumsum(np.cumsum(rng.random((96, 140)), 0), 1)
    tex = (tex / tex.max() * 200 + 20).astype(np.float32)
    clip = np.stack([tex[2 * t:2 * t + 64, 3 * t:3 * t + 96] for t in range(5)])
    clip = np.clip(np.stack([clip, clip * 0.9, clip], -1), 0, 255).astype(np.uint8)
    g_cpu, d_cpu = motion_hint(torch.from_numpy(clip), 8)
    g_card, d_card = motion_hint(torch.from_numpy(clip).to(dev), 8)
    assert torch.equal(g_card.cpu(), g_cpu) and torch.equal(d_card.cpu(), d_cpu)
    assert g_cpu.abs().sum() > 0
    mask = torch.from_numpy((rng.random((5, 8, 12)) < 0.3).astype(np.int8))
    f_cpu = restore_removal_diffusion(torch.from_numpy(clip), mask, 8)
    f_card = restore_removal_diffusion(torch.from_numpy(clip).to(dev), mask.to(dev), 8)
    assert (f_card.cpu().int() - f_cpu.int()).abs().max().item() <= 1


def _holed_pan(seed, n=6, h=64, w=96):
    """A smooth textured clip panning (2, 3) px a frame with a quarter of
    its blocks removed (black), the mask, and a quarter-pel motion field
    near the true pan (what the motion hint carries)."""
    rng = np.random.default_rng(seed)
    tex = np.cumsum(np.cumsum(rng.random((h + 2 * n, w + 3 * n)), 0), 1)
    tex = (tex / tex.max() * 200 + 20) + 10 * np.sin(np.arange(w + 3 * n) / 3.0)
    clip = np.stack([tex[2 * t:2 * t + h, 3 * t:3 * t + w] for t in range(n)])
    clip = np.clip(np.stack([clip, clip * 0.9, 255 - clip], -1), 0, 255).astype(np.uint8)
    mask = (rng.random((n, h // 8, w // 8)) < 0.25).astype(np.int8)
    hole = np.repeat(np.repeat(mask.astype(bool), 8, 1), 8, 2)
    holed = np.where(hole[..., None], 0, clip).astype(np.uint8)
    field = np.broadcast_to(np.float32([-2.0, -3.0]), (n, h // 8, w // 8, 2)).copy()
    field += (rng.integers(-1, 2, field.shape) / 4.0).astype(np.float32)
    field[0] = 0
    return clip, holed, mask, hole, field


@pytest.mark.gpu
@pytest.mark.parametrize("hint", [True, False])
def test_temporal_fill_on_card_matches_cpu(hint):
    """The temporal fill on the card against the same call on the CPU:
    known pixels bit-equal; hole pixels within 1 LSB on at least 99.5% of
    them (the scatter inverse adds with float atomics on the card, and the
    block means reduce in another order, so a near tie can pick another
    source block)."""
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal

    dev = _cuda()
    _, holed, mask, hole, field = _holed_pan(7)
    kw = {"window": 4, "ref_stride": 3}
    mv = torch.from_numpy(field) if hint else None
    want = restore_removal_temporal(torch.from_numpy(holed), torch.from_numpy(mask), 8,
                                    motion_field=mv, **kw).numpy()
    got = restore_removal_temporal(torch.from_numpy(holed).to(dev),
                                   torch.from_numpy(mask).to(dev), 8,
                                   motion_field=None if mv is None else mv.to(dev), **kw)
    assert got.is_cuda and got.dtype == torch.uint8
    got = got.cpu().numpy()
    assert np.array_equal(got[~hole], want[~hole])
    d = np.abs(got[hole].astype(int) - want[hole].astype(int))
    assert (d <= 1).mean() >= 0.995, ((d <= 1).mean(), d.max())


@pytest.mark.gpu
def test_inpaint_net_on_card_matches_cpu():
    """The shipped InpaintNet (bf16 body, float32 tail) on the card against
    the CPU's bf16 net: only holes change; hole pixels within 1 grey level
    (max abs; the card read 0.46 on this clip, 0.38 on a 256x512 crop of
    the 1080p default run's shrunk branch); the residual is real, its mean over the holes above that bound
    (5.43 here), and the card's mean error at most 2% of the CPU's mean
    residual (read 0.38%); and the hole PSNR against the clip within 0.05 dB
    (the bf16 bar of the CPU parity tests; the net moves it 0.58 dB from its
    seed here)."""
    from elvis_tpu_torch.models.io import load_inpaint, weights_path

    dev = _cuda()
    clip, holed, mask, hole, _ = _holed_pan(8)
    seeded = np.where(hole[..., None], 128, holed).astype(np.float32)
    with torch.no_grad():
        want = load_inpaint(weights_path("inpaint"), device="cpu")(
            torch.from_numpy(seeded), torch.from_numpy(mask), 8).numpy()
        got = load_inpaint(weights_path("inpaint"), device=dev)(
            torch.from_numpy(seeded).to(dev), torch.from_numpy(mask).to(dev), 8).cpu().numpy()
    assert np.array_equal(got[~hole], seeded[~hole])
    err = np.abs(got - want)[hole].max()
    residual = np.abs(got - seeded)[hole].mean()
    rel = np.abs(got - want)[hole].mean() / np.abs(want - seeded)[hole].mean()
    print(f"net card vs CPU: hole max abs {err} grey levels, mean residual {residual}, "
          f"mean error {rel} of the CPU's mean residual")
    assert err <= 1.0 < residual, (err, residual)
    assert rel <= 0.02, rel

    def hole_psnr(o):
        mse = ((o.astype(np.float64) - clip) ** 2).mean(-1)[hole].mean()
        return 10 * np.log10(255.0 ** 2 / mse)

    assert abs(hole_psnr(got) - hole_psnr(want)) <= 0.05


@pytest.mark.gpu
def test_run_elvis_on_card_matches_cpu(tmp_path):
    """run_elvis at 6 frames of 96x64 on the card and on the CPU: the same
    rows, each within the CPU-parity tolerances of
    tests/test_torch_pipeline.py (bitrate 1%, PSNR 0.1 dB, SSIM 2e-3, LPIPS
    1e-3)."""
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    _cuda()
    kw = dict(reference_video="synthetic://moving?frames=6&fps=30", width=96, height=64,
              enable_vmaf=False, stage_cache=False, target_bitrate_override=100_000,
              verbose=False)
    stats = {}
    card = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "card"), **kw), device="cuda",
                     stats=stats)
    assert set(stats["stage_peak_bytes"]) <= set(card["execution_times_seconds"])
    assert stats["stage_peak_bytes"]["Performance Evaluation"] > 0
    cpu = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "cpu"), **kw), device="cpu")
    rows = [k for k, v in cpu.items() if isinstance(v, dict) and "foreground" in v]
    assert rows == [k for k, v in card.items() if isinstance(v, dict) and "foreground" in v]
    assert len(rows) == 9  # the default config: ProPainter and E2FGVI rows included
    for row in rows:
        a, b = card[row], cpu[row]
        assert abs(a["bitrate_mbps"] - b["bitrate_mbps"]) <= 0.01 * b["bitrate_mbps"], row
        for region in ("foreground", "background"):
            assert abs(a[region]["psnr_mean"] - b[region]["psnr_mean"]) <= 0.1, (row, region)
            assert abs(a[region]["ssim_mean"] - b[region]["ssim_mean"]) <= 2e-3, (row, region)
            assert abs(a[region]["lpips_mean"] - b[region]["lpips_mean"]) <= 1e-3, (row, region)
            assert np.isfinite(a[region]["fvmd"]), (row, region)


# the diffusion restore on the card against the CPU, bf16 on both sides and
# the same noise, grey levels. The card
# read max 0.431, mean 0.035 here, with a CPU change of the input of 7.6
DIFFUSION_MAX_GREY = 1.0
DIFFUSION_MEAN_GREY = 0.1


def _smooth_clip(n, h, w, seed=0):
    """uint8 frames: a bilinear upscale of noise (smooth content)."""
    rng = np.random.default_rng(seed)
    small = torch.as_tensor(rng.integers(0, 256, (n, 3, h // 8, w // 8)).astype(np.float32))
    big = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                          align_corners=False)
    return torch.clamp(torch.round(big), 0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


@pytest.mark.gpu
def test_dct_dampen_on_card_matches_cpu():
    """Levels equal; the dampened frames and the inverse within 1 LSB."""
    from elvis_tpu_torch.degrade import dct_dampen
    from elvis_tpu_torch.restore import restore_dct_dampen_inverse

    dev = _cuda()
    frames = _smooth_clip(4, 64, 96)
    scores = torch.as_tensor(np.random.default_rng(1).random((4, 8, 12)).astype(np.float32))
    d_card, l_card = dct_dampen(frames.to(dev), scores.to(dev), 8)
    d_cpu, l_cpu = dct_dampen(frames, scores, 8)
    assert torch.equal(l_card.cpu(), l_cpu)
    assert (d_card.cpu().int() - d_cpu.int()).abs().max() <= 1
    i_card = restore_dct_dampen_inverse(d_card, l_card, 8).cpu()
    i_cpu = restore_dct_dampen_inverse(d_cpu, l_cpu, 8)
    assert (i_card.int() - i_cpu.int()).abs().max() <= 1


@pytest.mark.gpu
def test_saliency_net_on_card_matches_cpu():
    """The 'neural' backend's block masks agree on at least 99.5% of blocks."""
    from elvis_tpu_torch.scoring import get_saliency_fn, saliency_to_block_mask

    dev = _cuda()
    frames = _smooth_clip(6, 64, 96, seed=2)
    sal = get_saliency_fn("neural")
    card, cpu = sal(frames.to(dev)).cpu(), sal(frames)
    print(f"saliency net card vs CPU: max abs {float((card - cpu).abs().max()):.4g}")
    agree = (saliency_to_block_mask(card, 8) == saliency_to_block_mask(cpu, 8)).float().mean()
    assert float(agree) >= 0.995


@pytest.mark.gpu
def test_diffusion_restore_on_card_matches_cpu():
    """restore_adaptive (20 steps) with the same noise: max and mean error
    within the bounds, and the restore moves the input by more than the
    mean bound (an identity restorer fails)."""
    from elvis_tpu_torch.models.io import load_diffusion, weights_path

    dev = _cuda()
    frames = _smooth_clip(2, 64, 96, seed=3)
    levels = torch.as_tensor(np.random.default_rng(3).integers(0, 11, (2, 8, 12)),
                             dtype=torch.int32)
    noise = torch.randn(frames.shape, generator=torch.Generator().manual_seed(0))
    card_net = load_diffusion(weights_path("diffusion"), device=dev)
    cpu_net = load_diffusion(weights_path("diffusion"), device="cpu")
    card = card_net.restore_adaptive(frames.to(dev), levels.to(dev), 8, noise=noise.to(dev))
    cpu = cpu_net.restore_adaptive(frames, levels, 8, noise=noise)
    err = (card.cpu() - cpu).abs()
    change = float((cpu - frames.float()).abs().mean())
    print(f"diffusion card vs CPU: max {float(err.max()):.4g}, mean {float(err.mean()):.4g} "
          f"grey levels; CPU change of the input {change:.4g}")
    assert float(err.max()) <= DIFFUSION_MAX_GREY
    assert float(err.mean()) <= DIFFUSION_MEAN_GREY < change


@pytest.mark.gpu
def test_naive_diffusion_on_card_returns_its_input():
    from elvis_tpu_torch.restore import naive_diffusion_restore

    dev = _cuda()
    frames = _smooth_clip(2, 64, 96, seed=4).to(dev)
    out = naive_diffusion_restore(frames, torch.zeros((2, 8, 12), device=dev), 8)
    assert torch.equal(out, frames)


@pytest.mark.gpu
def test_srnet_large_on_card_matches_cpu():
    """The srnet_large tier: restored PSNR within 0.05 dB (the bound of the
    main path's crop check, ``test_main_path_at_1080p_on_the_card``)."""
    from elvis_tpu_torch.metrics import masked_psnr
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    dev = _cuda()
    frames = _smooth_clip(2, 64, 96, seed=5)
    levels = torch.as_tensor(np.random.default_rng(5).integers(0, 4, (2, 8, 12)),
                             dtype=torch.int32)
    card_fn, _ = resolve_sr_backend("srnet_large", ElvisConfig(), device=dev)
    cpu_fn, _ = resolve_sr_backend("srnet_large", ElvisConfig(), device="cpu")
    card = card_fn(frames.to(dev), levels.to(dev), 8).cpu()
    cpu = cpu_fn(frames, levels, 8)
    assert float((masked_psnr(frames, card) - masked_psnr(frames, cpu)).abs().max()) <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["srnet", "srnet_ensemble"])
def test_rrdb_and_ensemble_on_card_match_cpu(name):
    """RRDB SRNet and the ensemble (compact + RRDB + large): restored PSNR
    within 0.05 dB of the CPU's, uint8 within 1 LSB on 99.5% of pixels (the
    PSNR bound of ``test_rrdb_and_ensemble_on_a_1080p_crop_match_cpu``)."""
    from elvis_tpu_torch.metrics import masked_psnr
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    dev = _cuda()
    frames = _smooth_clip(2, 64, 96, seed=6)
    levels = torch.as_tensor(np.random.default_rng(6).integers(0, 4, (2, 8, 12)),
                             dtype=torch.int32)
    card_fn, card_prov = resolve_sr_backend(name, ElvisConfig(), device=dev)
    cpu_fn, cpu_prov = resolve_sr_backend(name, ElvisConfig(), device="cpu")
    assert card_prov == cpu_prov and ("srnet_ensemble[" in card_prov) == (name != "srnet")
    card = card_fn(frames.to(dev), levels.to(dev), 8).cpu()
    cpu = cpu_fn(frames, levels, 8)
    assert float((masked_psnr(frames, card) - masked_psnr(frames, cpu)).abs().max()) <= 0.05
    diff = (card.to(torch.int16) - cpu.to(torch.int16)).abs()
    assert float((diff <= 1).float().mean()) >= 0.995


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(135, 240), (540, 960)])  # 1080p's coarsest (odd) and widest
def test_realesrgan_x2plus_at_published_width_matches_the_benchmark_reference(h, w, tmp_path):
    """The ``realesrgan_x2plus`` tier (64 features, growth 32, 23 RRDBs) on
    the benchmark configuration's seeded weights, one call on a stage input
    of the 1080p loop, against the benchmark's plain float32 reference:
    rounded outputs within the configuration's limits of ``correct``, and
    every conv before ``conv_last`` through the fused epilogue (350 a call)."""
    import json
    import sys
    from pathlib import Path

    from elvis_tpu_torch.models.io import load_srnet
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.utils.trace import counter

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from port_bench.harness import content
    from port_bench.paths.restore_seeded import seeded_weights, write_weights
    from port_bench.reference.realesrgan import ReferenceRealESRGAN

    dev = _cuda()
    cfg = json.loads((root / "port_bench/configs/realesrgan_x2plus_1080p.json").read_text())
    path = str(tmp_path / "x2.npz")
    write_weights(path, cfg["arch"], seeded_weights(cfg["arch"], cfg["weights_seed"],
                                                    cfg["assumed"]))
    mix = json.loads((root / "port_bench/traffic/segments_1080p_restore.json").read_text())
    src = content.make_segments(mix["content"], 1, 2, 1080, 1920,
                                content.generator(2**31 + 3, dev), dev)[0].float()
    x = torch.nn.functional.interpolate(src.permute(0, 3, 1, 2), size=(h, w), mode="area")
    x = x.permute(0, 2, 3, 1).contiguous()
    up = srnet_upsample_fn(load_srnet(path, dev))
    nets = counter("nets")
    fused = nets["epilogue.fused"]
    got = up(x).round()
    assert nets["epilogue.fused"] == fused + 350
    want = ReferenceRealESRGAN(path, dev)(x).round()
    assert got.shape == want.shape == (2, 2 * h, 2 * w, 3)
    assert float(((want <= 0) | (want >= 255)).float().mean()) < 0.05
    diff = (got - want).abs()
    limits = cfg["checks"]["restore_seeded"]["limits"]
    assert float(diff.mean(dim=(1, 2, 3)).max()) <= limits["frame_mae_lsb"], float(diff.mean())
    assert float((diff > 4).float().mean()) <= limits["over4_share"]


def _dcn_inputs(n, h, w, c, groups, dev, seed):
    """Features, E2FGVI-like offsets (a flow of a few pixels plus ``10 tanh``
    of a small draw, some taps off the frame), a sigmoid mask, an OIHW weight
    and a bias: bf16 features and weights, float32 offsets and mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
    flow = torch.randn((n, 1, 1, 2), generator=gen, device=dev) * 3
    offset = 10 * torch.tanh(0.3 * torch.randn((n, h, w, 18 * groups), generator=gen,
                                                device=dev)) + flow.repeat(1, h, w, 9 * groups)
    mask = torch.sigmoid(torch.randn((n, h, w, 9 * groups), generator=gen, device=dev))
    weight = (torch.randn((128, c, 3, 3), generator=gen, device=dev) / (9 * c) ** 0.5)
    bias = torch.randn((128,), generator=gen, device=dev)
    return x, offset, mask, weight.to(torch.bfloat16), bias.to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c,groups", [(8, 270, 486, 256, 16),  # the cell's propagation
                                            (3, 37, 53, 64, 8), (2, 17, 29, 48, 3)])
def test_dcn_kernel_matches_plain(n, h, w, c, groups):
    """The deformable conv's sampling kernel: its bf16 columns bit-equal to
    the plain version's on the card, frame by frame; the whole conv (one
    GEMM a frame chunk) within the bf16 GEMM's rounding of the plain
    version's; one launch a frame chunk."""
    from elvis_tpu_torch.kernels import dcn

    dev = _cuda()
    x, offset, mask, weight, bias = _dcn_inputs(n, h, w, c, groups, dev, seed=h + c)
    for i in range(n):
        got = dcn.deform_columns_cuda(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups)
        want = dcn.deform_columns(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups)
        assert torch.equal(got, want), (i, (got.float() - want.float()).abs().max().item())
    chunk = max(1, dcn.COLUMN_BUDGET_BYTES // (h * w * c * 9 * 2))
    before = dcn.LAUNCHES["dcn"]
    out = dcn.modulated_deform_conv(x, offset, mask, weight, bias, groups)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES["dcn"] == before + -(-n // chunk)
    packed = dcn.pack_weight(weight, groups).float()
    for i in range(n):
        cols = dcn.deform_columns(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups).float()
        exact = cols.reshape(-1, 9 * c) @ packed + bias.float()
        err = (out[i].reshape(-1, 128).float() - exact).abs()
        assert float((err - 2.0**-7 * exact.abs()).max()) <= 1e-2, float(err.max())


@pytest.mark.gpu
def test_e2fgvi_hq_at_published_width_matches_the_benchmark_reference(tmp_path, monkeypatch):
    """The ``e2fgvi_hq`` backend (every published width, 8 blocks, 16 deform
    groups) on the benchmark configuration's seeded weights, 8 frames of
    240x432 with a quarter of the blocks removed (4x4 attention windows),
    against the benchmark's plain float32 reference: non-hole pixels
    bit-equal, the holes (the removed blocks dilated by 4 px) within the
    configuration's limits of ``correct``; one ``dcn.calls`` and one kernel
    launch a propagation step (forwards over frames 0-5 and 0-7: 2 x 5 + 2 x
    7); every trunk conv fused. cuDNN's algorithm search, which the backend
    turns on, is put back afterwards."""
    import json
    import sys
    from pathlib import Path

    from elvis_tpu_torch.degrade.removal import apply_selective_removal, stretch_frames
    from elvis_tpu_torch.kernels import dcn
    from elvis_tpu_torch.pipeline.config import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_inpaint_backend
    from elvis_tpu_torch.utils.trace import counter

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from port_bench.harness import content
    from port_bench.paths import inpaint_seeded as ps
    from port_bench.reference.e2fgvi import ReferenceE2FGVI

    dev = _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", torch.backends.cudnn.benchmark)
    cfg = json.loads((root / "port_bench/configs/e2fgvi_hq_1080p.json").read_text())
    path = str(tmp_path / "e2fgvi_hq.npz")
    ps.write_weights(path, ps.seeded_weights(cfg["arch"], cfg["weights_seed"], cfg["assumed"]))
    mix = json.loads((root / "port_bench/traffic/segments_1080p_removal_seeded.json").read_text())
    n, h, w = 8, 240, 432
    gen = content.generator(2**31 + 11, dev)
    src = content.make_segments(mix["content"], 1, n, h, w, gen, dev)[0]
    scores = ps.removability(mix["removal"], 1, n, h // 8, w // 8, gen, dev)[0]
    shrunk, mask = apply_selective_removal(src, scores, 8, 0.25, 1)
    frames = stretch_frames(shrunk, mask, 8)
    fn, prov = resolve_inpaint_backend("e2fgvi_hq", ElvisConfig(inpaint_params_path=path),
                                       device=dev)
    assert prov.startswith("e2fgvi_hq:"), prov
    nets = counter("nets")
    before = (nets["dcn.calls"], dcn.LAUNCHES["dcn"], nets["epilogue.plain"])
    got = fn(frames, mask, 8)
    torch.cuda.synchronize()
    assert (nets["dcn.calls"] - before[0], dcn.LAUNCHES["dcn"] - before[1]) == (24, 24)
    assert nets["epilogue.plain"] == before[2]
    hole = ps.hole_pixels(mask, 8, 4)
    blocks = ps.hole_pixels(mask, 8, 0)
    want = ReferenceE2FGVI(path, dev).inpaint(frames, hole, 5, 10, -1)
    gaps = ps.compare(got, want, frames, hole)
    limits = cfg["checks"]["inpaint_seeded"]["limits"]
    assert gaps["nonhole_changed"] == 0, gaps
    assert all(gaps[k] <= lim for k, lim in limits.items()), gaps
    assert not torch.equal(got[hole & ~blocks], frames[hole & ~blocks])  # the dilation fills


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 16, 32])
def test_roi_files_on_card_match_cpu(b, tmp_path):
    """The ROI writers regridding on the card against the CPU at 1080p: the
    same CTU (16 at b=8), lines and tokens, qpfile values within 1e-4,
    kvazaar bytes equal, the SVT-AV1 segments within one level."""
    from elvis_tpu_torch.codec import roi

    dev = _cuda()
    w, h = 1920, 1080
    scores = np.random.default_rng(b).random((2, h // b, w // b)).astype(np.float32)
    files = {}
    for where in ("cpu", dev):
        q, k, s = (tmp_path / f"{where.__str__()}.{ext}" for ext in ("qp", "bin", "txt"))
        ctu = roi.write_x265_qpfile(str(q), scores, b, w, h, device=where)
        roi.write_kvazaar_roi(str(k), 1 - scores, base_qp=32, qp_range=12)
        roi.write_svtav1_roi(str(s), 1 - scores, base_crf=40, qp_range=12, width=w, height=h,
                             device=where)
        files[str(where)] = (ctu, q.read_text(), k.read_bytes(), s.read_text())
    cpu, card = files["cpu"], files[str(dev)]
    assert card[0] == cpu[0] and card[2] == cpu[2]
    assert b != 8 or cpu[0] == 16  # the CTU at the pipeline's block size
    q_cpu, q_card = cpu[1].splitlines(), card[1].splitlines()
    assert len(q_cpu) == len(q_card)
    assert all(len(a.split()) == len(c.split()) for a, c in zip(q_cpu, q_card))
    for a, c in zip(cpu[1].split(), card[1].split()):
        if "," in a:
            (ka, va), (kc, vc) = a.rsplit(",", 1), c.rsplit(",", 1)
            assert ka == kc and abs(float(va) - float(vc)) <= 1e-4 + 1e-9
        else:
            assert a == c
    for a, c in zip(cpu[3].split(), card[3].split()):
        assert abs(int(a) - int(c)) <= (2 * 12) // 7 + 1  # one of the 8 segments


@pytest.fixture
def logical_card(monkeypatch):
    """``k`` logical shards of cuda:0 for the port's meshes."""
    from elvis_tpu_torch.parallel import mesh as pmesh

    def use(k):
        monkeypatch.setattr(pmesh, "devices",
                            lambda device_type="cuda": [torch.device("cuda:0")] * k)

    return use


@pytest.mark.gpu
def test_halo_functions_on_logical_shards_of_the_card(logical_card):
    """A 3-tap temporal mean over 4 logical shards of the card equals the
    unsharded mean of the clip with its edge replicas (1e-5); the
    progressive Lanczos restore height-tiled over a data 2 x spatial 2 mesh
    with a 32-row halo equals the unsharded restore (0.1 max, 1e-3 mean: the
    JAX package's bound)."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.parallel import make_mesh, spatial_tile_map_blocks, temporal_map_overlap
    from elvis_tpu_torch.restore import progressive_restore

    dev = _cuda()
    logical_card(4)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((16, 8, 8, 3), generator=g, device=dev)

    def tf(e):
        p = torch.cat([e[:1], e, e[-1:]])
        return (p[:-2] + p[1:-1] + p[2:]) / 3.0

    got = temporal_map_overlap(tf, x, make_mesh(), overlap=1)
    torch.testing.assert_close(got, tf(x), atol=1e-5, rtol=0)
    frames = torch.rand((2, 128, 32, 3), generator=g, device=dev) * 255
    degraded, levels = adaptive_downsample(frames, torch.rand((2, 16, 4), generator=g,
                                                              device=dev), 8)
    mesh = make_mesh((("data", 2), ("spatial", 2)))
    out = spatial_tile_map_blocks(lambda f, lv: progressive_restore(f, lv, 8), degraded, levels,
                                  mesh, 32, 8, data_axis="data")
    err = (out - progressive_restore(degraded, levels, 8)).abs()
    assert float(err.max()) < 0.1 and float(err.mean()) < 1e-3


@pytest.mark.gpu
def test_run_elvis_over_logical_shards_of_the_card(logical_card, tmp_path):
    """run_elvis at 6x96x64 with the default config over 4 logical shards of
    the card against the unsharded run on the card: the same rows within
    PR 5's tolerances (bitrate 1%, PSNR 0.1 dB, SSIM 2e-3, LPIPS 1e-3)."""
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    _cuda()
    kw = dict(reference_video="synthetic://moving?frames=6&fps=30", width=96, height=64,
              enable_vmaf=False, stage_cache=False, target_bitrate_override=100_000,
              verbose=False)
    one = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "one"), **kw), device="cuda")
    logical_card(4)
    four = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "four"), **kw), device="cuda")
    rows = [k for k, v in one.items() if isinstance(v, dict) and "foreground" in v]
    assert rows == [k for k, v in four.items() if isinstance(v, dict) and "foreground" in v]
    for row in rows:
        a, b = four[row], one[row]
        assert abs(a["bitrate_mbps"] - b["bitrate_mbps"]) <= 0.01 * b["bitrate_mbps"]
        for region in ("foreground", "background"):
            assert abs(a[region]["psnr_mean"] - b[region]["psnr_mean"]) <= 0.1, (row, region)
            assert abs(a[region]["ssim_mean"] - b[region]["ssim_mean"]) <= 2e-3, (row, region)
            assert abs(a[region]["lpips_mean"] - b[region]["lpips_mean"]) <= 1e-3, (row, region)


@pytest.mark.gpu
def test_train_steps_on_the_card_match_the_cpu():
    """Three AdamW steps (lr 1e-3) of a float32 SRNetCompact through the SR
    loss at full float32 precision, on the card and on the CPU, from the
    same parameters (a random tail, so no gradient starts at ~0) on the same
    batches: the parameters within 1e-5 (they move by ~3e-3), the losses
    within 1e-5 relative."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.device import full_fp32
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.parallel import make_mesh
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train import Trainer

    dev = _cuda()
    torch.manual_seed(0)
    base = SRNetCompact(16, 2, dtype=torch.float32)
    with torch.no_grad():
        base.tail.weight.normal_(0, 0.05)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        clean = torch.from_numpy((rng.random((4, 32, 32, 3)) * 255).astype(np.float32))
        deg, lv = adaptive_downsample(clean, torch.from_numpy(
            rng.random((4, 4, 4)).astype(np.float32)), 8)
        batches.append((clean, deg, lv))

    def run(device):
        model = SRNetCompact(16, 2, dtype=torch.float32)
        model.load_state_dict(base.state_dict())
        model.to(device)

        def loss_fn(p, data):
            up = lambda f: torch.func.functional_call(model, p, (f,))  # noqa: E731
            out = progressive_restore(data[1], data[2], 8, upsample_fn=up, max_level=3)
            return torch.mean((out - data[0]) ** 2) / 255.0**2

        tr = Trainer(loss_fn, model, mesh=make_mesh(devices=[0], device_type=device.type),
                     learning_rate=1e-3, device=device)
        losses = [float(tr.step(tuple(x.to(device) for x in b))) for b in batches]
        return tr.params(torch.device("cpu")), losses

    with full_fp32():
        card, card_losses = run(dev)
        cpu, cpu_losses = run(torch.device("cpu"))
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-5)
    assert max(float((card[k] - cpu[k]).abs().max()) for k in cpu) <= 1e-5


@pytest.mark.gpu
def test_float32_student_steps_repeat_bit_for_bit_on_the_card():
    """Two AdamW steps of a float32 SRNetCompact through the SR loss under
    deterministic cuDNN, twice from the same start on the same batches:
    the same parameters and losses, bit for bit. The loss reaches the
    edge pad of ``upsample2x_phases`` from the second stage on, whose
    backward adds the edge copies in a fixed order."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.device import full_fp32
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.parallel import make_mesh
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train import Trainer

    dev = _cuda()
    torch.manual_seed(0)
    base = SRNetCompact(32, 2, dtype=torch.float32)
    with torch.no_grad():
        base.tail.weight.normal_(0, 0.05)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        clean = torch.from_numpy((rng.random((8, 64, 64, 3)) * 255).astype(np.float32)).to(dev)
        deg, lv = adaptive_downsample(clean, torch.from_numpy(
            rng.random((8, 8, 8)).astype(np.float32)).to(dev), 8)
        batches.append((clean, deg, lv))

    def run():
        model = SRNetCompact(32, 2, dtype=torch.float32)
        model.load_state_dict(base.state_dict())
        model.to(dev)

        def loss_fn(p, data):
            up = lambda f: torch.func.functional_call(model, p, (f,))  # noqa: E731
            out = progressive_restore(data[1], data[2], 8, upsample_fn=up, max_level=3)
            return torch.mean((out - data[0]) ** 2) / 255.0**2

        tr = Trainer(loss_fn, model, mesh=make_mesh(devices=[0], device_type="cuda"),
                     learning_rate=1e-4, device=dev)
        losses = [float(tr.step(b)) for b in batches]
        return tr.params(torch.device("cpu")), losses

    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with full_fp32():
            first, first_losses = run()
            again, again_losses = run()
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    assert first_losses == again_losses
    assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["diffusion", "inpaint", "saliency", "perceptual"])
def test_new_trainers_take_a_step_on_the_card(name, tmp_path):
    """Each of the diffusion, inpaint, saliency and perceptual trainers
    takes a step on the card at small sizes (procedural data: the card's
    machine has no PIL): a finite loss, the parameters on the card, the
    checkpoint written."""
    from elvis_tpu_torch.train import cli

    dev = _cuda()
    kw = dict(batch=4, patch=32) if name in ("diffusion", "perceptual") else dict(frames=4,
                                                                                 patch=32)
    tr = getattr(cli, f"train_{name}")(1, str(tmp_path), photo_fraction=0.0, device=dev,
                                       log_every=100, **kw)
    assert len(tr.losses) == len(tr.step_ms) == 1 and np.isfinite(tr.losses[0])
    assert all(p.is_cuda for p in tr.params().values())
    assert (tmp_path / f"{name}.npz").is_file()


@pytest.mark.gpu
def test_diffusion_trainer_launches_the_transform_kernel(monkeypatch):
    """The batch maker's ``adaptive_blur`` launches the transform kernel
    once a step and never runs its plain version."""
    from elvis_tpu_torch.kernels import block_transform as bt
    from elvis_tpu_torch.train.cli import train_diffusion

    dev = _cuda()

    def plain(*args, **kwargs):
        raise AssertionError("the plain transform ran on the card's path")

    monkeypatch.setattr(bt, "_plain_table_to_frames", plain)
    before = bt.LAUNCHES["block_transform"]
    tr = train_diffusion(3, None, batch=4, patch=32, photo_fraction=0.0, device=dev,
                         log_every=100)
    assert bt.LAUNCHES["block_transform"] == before + 3 and len(tr.losses) == 3


# --- the paths at full width: 8 frames of 1080p --------------------------
#
# The gates the paths' properties need at the size users run them: launch
# counts, the stage cache, the rows of whole runs, and what a clip's own
# pixels decide (levels, rounds, PSNR floors). Timing them is the
# benchmark's job (port_bench/run.py).

N, H, W, B = 8, 1080, 1920, 8
STUDENT_TRUNK_CONVS = 8  # srnet_student: head, six convs, up; each one conv_epilogue launch
# realesrgan_x2plus: 23 RRDBs x 3 dense blocks x 5 convs, conv_first, conv_body,
# conv_up1, conv_up2, conv_hr; conv_last is the float32 tail, one tail_conv launch
REALESRGAN_TRUNK_CONVS = 23 * 3 * 5 + 5
CROP = (256, 512)  # centre crops of the 1080p clip held to the CPU
SR_CROP = (128, 256)  # the RRDB tier and the ensemble: a CPU pass of a larger crop takes minutes
PIPELINE_ROWS = ("Baseline", "PRESLEY QP", "ELVIS CV2", "ELVIS ProPainter", "ELVIS E2FGVI",
                 "PRESLEY RealESRGAN", "PRESLEY InstantIR", "PRESLEY Lanczos", "PRESLEY Unsharp")
ROW_TOL = {"bitrate_rel": 0.01, "psnr_mean": 0.1, "ssim_mean": 2e-3, "lpips_mean": 1e-3}


def _clip(device, n=N, h=H, w=W):
    """bench.py's structured clip (moving gradients), grey in RGB, plus
    N(0, 2) noise from a generator seeded 0; uint8 (n, h, w, 3)."""
    t = torch.arange(n, device=device, dtype=torch.float32)[:, None, None]
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    grey = torch.clamp(128 + 80 * torch.sin(2 * np.pi * (xx + 40 * t) / 300)
                       * torch.cos(2 * np.pi * yy / 200), 0, 255)
    gen = torch.Generator(device=device).manual_seed(0)
    noise = torch.randn((n, h, w, 3), generator=gen, device=device) * 2.0
    return torch.clamp(torch.round(grey[..., None] + noise), 0, 255).to(torch.uint8)


def _score(frames, cfg):
    """Removability scores and the foreground (saliency >= 0.5), as the
    pipeline's scoring stage makes them."""
    from elvis_tpu_torch.scoring import (get_saliency_fn, removability_scores,
                                         saliency_to_block_mask, spatial_temporal_complexity)

    cx = spatial_temporal_complexity(frames, cfg.block_size)
    sal = get_saliency_fn(cfg.saliency_backend)(frames)
    scores = removability_scores(cx.SC, cx.TC, saliency_to_block_mask(sal, cfg.block_size),
                                 alpha=cfg.removability_alpha,
                                 smoothing_beta=cfg.removability_smoothing_beta)
    return scores, sal >= 0.5


def _centre(shape, rows, cols):
    """Pixel and block slices of a centre crop on whole 2x2-block steps."""
    y0 = (shape[1] // 2 - rows // 2) // (2 * B) * (2 * B)
    x0 = (shape[2] // 2 - cols // 2) // (2 * B) * (2 * B)
    return ((slice(y0, y0 + rows), slice(x0, x0 + cols)),
            (slice(y0 // B, (y0 + rows) // B), slice(x0 // B, (x0 + cols) // B)))


def _transforms(fn):
    """``fn()`` and the transform kernel launches it made."""
    from elvis_tpu_torch.kernels import LAUNCHES

    before = LAUNCHES["block_transform"]
    out = fn()
    return out, LAUNCHES["block_transform"] - before


def _rows(results):
    return [k for k, v in results.items() if isinstance(v, dict) and "foreground" in v]


def _rows_apart(a, b, relative=False):
    """Largest difference of each metric between two runs' rows: relative
    for the bitrate, absolute (or relative) for the rest."""
    worst = {}
    for row in _rows(b):
        worst["bitrate_rel"] = max(worst.get("bitrate_rel", 0.0),
                                   abs(a[row]["bitrate_mbps"] - b[row]["bitrate_mbps"])
                                   / b[row]["bitrate_mbps"])
        for region in ("foreground", "background"):
            for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
                d = abs(a[row][region][key] - b[row][region][key])
                if relative:
                    d /= max(abs(b[row][region][key]), 1e-12)
                worst[key] = max(worst.get(key, 0.0), d)
    return worst


def _rows_finite(run):
    for row in _rows(run):
        for region in ("foreground", "background"):
            for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
                assert np.isfinite(run[row][region][key]), (row, region, key)


def _logical_mesh(k, axes=(("data", -1),)):
    """A mesh over ``k`` logical shards of cuda:0: the port's device list is
    replaced while the mesh is made."""
    from elvis_tpu_torch.parallel import make_mesh
    from elvis_tpu_torch.parallel import mesh as pmesh

    real = pmesh.devices
    pmesh.devices = lambda device_type="cuda": [torch.device("cuda:0")] * k
    try:
        return make_mesh(axes, device_type="cuda")
    finally:
        pmesh.devices = real


@pytest.mark.gpu
def test_main_path_at_1080p_on_the_card():
    """Scoring, ``adaptive_downsample`` and the default SR slot (the shipped
    ``srnet_student``) on the 1080p clip: one transform launch, one fused
    ``conv_epilogue`` launch per trunk conv and stage, finite metrics, the
    restore no more than 1 dB under the degraded frames; on a 2x64x96 crop
    the card's scores within 1e-4 of the CPU's, the same levels, the
    degraded frames within 1 LSB and the restored PSNR within 0.05 dB."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.utils.trace import counter

    dev = _cuda()
    cfg = ElvisConfig()
    assert cfg.block_size == B
    frames = _clip(dev)
    restore, prov = resolve_sr_backend(cfg.sr_backends[0], cfg, device=dev)
    assert prov.startswith("progressive_neural[srnet_student:"), prov
    nets = counter("nets")
    LAUNCHES.clear()
    nets.clear()
    scores, fg = _score(frames, cfg)
    degraded, levels = adaptive_downsample(frames, scores, B)
    restored = restore(degraded, levels, B)
    metrics = [masked_psnr(frames, degraded), masked_psnr(frames, restored),
               masked_psnr(frames, restored, fg), masked_ssim(frames, restored)]
    launches, net_convs = dict(LAUNCHES), dict(nets)
    assert launches.get("block_transform", 0) == 1, launches
    assert restored.shape == degraded.shape == frames.shape
    assert restored.dtype == degraded.dtype == torch.uint8
    max_level = int(levels.max())
    assert max_level >= 1
    want = STUDENT_TRUNK_CONVS * max_level
    assert launches.get("conv_epilogue", 0) == want, launches
    assert launches.get("tail_conv", 0) == max_level, launches  # one tail a stage
    assert net_convs == {"epilogue.fused": want, "tail.fused": max_level}, net_convs
    assert all(bool(torch.isfinite(v).all()) for v in metrics)
    assert metrics[1].mean().item() > metrics[0].mean().item() - 1.0

    crop = frames[:2, :64, :96].contiguous()
    s_card, _ = _score(crop, cfg)
    s_cpu, _ = _score(crop.cpu(), cfg)
    assert (s_card.cpu() - s_cpu).abs().max().item() <= 1e-4
    cpu_restore, _ = resolve_sr_backend(cfg.sr_backends[0], cfg, device="cpu")
    d_card, l_card = adaptive_downsample(crop, s_card, B)
    d_cpu, l_cpu = adaptive_downsample(crop.cpu(), s_card.cpu(), B)
    assert torch.equal(l_card.cpu(), l_cpu)
    assert (d_card.cpu().int() - d_cpu.int()).abs().max().item() <= 1
    p_card = masked_psnr(crop.cpu(), restore(d_card, l_card, B).cpu())
    p_cpu = masked_psnr(crop.cpu(), cpu_restore(d_cpu, l_cpu, B))
    assert (p_card - p_cpu).abs().max().item() <= 0.05


@pytest.mark.gpu
def test_realesrgan_x2plus_tier_fuses_every_conv_of_a_1080p_stage(tmp_path):
    """The pinned ``realesrgan_x2plus`` tier through ``resolve_sr_backend``
    on PyTorch's default init written as a weights file, over one 2x stage
    of the 1080p clip (every block at level 1): uint8 out, and one fused
    ``conv_epilogue`` launch for each of its 350 convs before ``conv_last``."""
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.models import io as tio
    from elvis_tpu_torch.models.srnet import RealESRGANx2
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.utils.trace import counter

    dev = _cuda()
    torch.manual_seed(0)
    path = str(tmp_path / "realesrgan_x2plus.npz")
    tio.write_npz(path, RealESRGANx2(dtype=torch.float32).state_dict(),
                  {"arch": tio.REALESRGAN_ARCH, "num_feat": 64, "num_grow_ch": 32,
                   "num_block": 23, "scale": 2})
    restore, prov = resolve_sr_backend("realesrgan_x2plus",
                                       ElvisConfig(srnet_params_path=path), device=dev)
    assert prov.startswith("progressive_neural[realesrgan_x2plus:"), prov
    frames = _clip(dev)
    levels = torch.ones((N, H // B, W // B), dtype=torch.int32, device=dev)
    nets = counter("nets")
    LAUNCHES.clear()
    nets.clear()
    restored = restore(frames, levels, B)
    torch.cuda.synchronize()
    assert restored.shape == frames.shape and restored.dtype == torch.uint8
    assert LAUNCHES.get("conv_epilogue", 0) == REALESRGAN_TRUNK_CONVS, dict(LAUNCHES)
    assert LAUNCHES.get("tail_conv", 0) == 1, dict(LAUNCHES)
    assert dict(nets) == {"epilogue.fused": REALESRGAN_TRUNK_CONVS, "tail.fused": 1}, dict(nets)


# the nets' float32 tail at the cells' shapes: RRDB's finest stage (8 x 540 x
# 960 in) in phase form, Real-ESRGAN's conv_last at 2x (8 x 1080 x 1920)
TAIL_SHAPES = {"rrdb_phase": (8, 540, 960, 2, 2, 128),
               "realesrgan_conv_last": (8, 1080, 1920, 64)}


def _tail_errors(x, w, b, fn):
    """Largest |fn(frame) - float64 conv| over the frames of ``x`` (bf16,
    either geometry), ``fn`` given one frame; the float64 conv runs frame by
    frame on the full-resolution image."""
    import torch.nn.functional as F

    from elvis_tpu_torch.ops.resize import interleave_phases

    worst = 0.0
    for i in range(x.shape[0]):
        xi = x[i:i + 1]
        full = interleave_phases(xi) if xi.dim() == 6 else xi
        ref = F.conv2d(full.double().permute(0, 3, 1, 2).contiguous(), w.double(), b.double(),
                       padding=1)
        got = fn(xi)
        got = interleave_phases(got) if xi.dim() == 6 else got
        worst = max(worst, (got.permute(0, 3, 1, 2).double() - ref).abs().max().item())
        del ref, got
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TAIL_SHAPES))
def test_tail_kernel_precision_and_determinism_at_the_cells_shapes(name):
    """The ``tail_conv`` kernel on a bf16 input at a restore cell's shape:
    its largest error against a float64 conv of the same bf16 input and
    float32 weights is at most twice that of cuDNN's float32 conv (TF32 off)
    on the same inputs, and the same conv in TF32 exceeds that limit (the
    check tells a precision down apart). Two calls are bit-equal."""
    import torch.nn.functional as F

    from elvis_tpu_torch.device import full_fp32
    from elvis_tpu_torch.kernels import tail_conv as tc
    from elvis_tpu_torch.ops.resize import deinterleave_phases, interleave_phases

    dev = _cuda()
    shape = TAIL_SHAPES[name]
    cin = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(cin)
    x = (torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = torch.randn((3, cin, 3, 3), generator=gen, device=dev) / (9 * cin) ** 0.5
    b = torch.randn((3,), generator=gen, device=dev)

    def cudnn(xi, tf32):
        full = interleave_phases(xi) if xi.dim() == 6 else xi
        with full_fp32():  # which restores the TF32 setting on exit
            torch.backends.cudnn.allow_tf32 = tf32
            out = F.conv2d(full.float().permute(0, 3, 1, 2), w, b, padding=1)
        out = out.permute(0, 2, 3, 1)
        return deinterleave_phases(out) if xi.dim() == 6 else out

    before = tc.LAUNCHES["tail_conv"]
    first = tc.tail_conv_cuda(x, w, b)
    second = tc.tail_conv_cuda(x, w, b)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["tail_conv"] == before + 2
    assert first.shape == shape[:-1] + (3,) and torch.equal(first, second)
    del second
    kernel = _tail_errors(x, w, b, lambda xi: tc.tail_conv_cuda(xi, w, b))
    fp32 = _tail_errors(x, w, b, lambda xi: cudnn(xi, False))
    tf32 = _tail_errors(x, w, b, lambda xi: cudnn(xi, True))
    print(f"[tail] {name}: largest error kernel {kernel:.3e}, cuDNN float32 {fp32:.3e}, "
          f"cuDNN TF32 {tf32:.3e}")
    assert 0 < kernel <= 2 * fp32, (kernel, fp32)
    assert tf32 > 2 * fp32, (tf32, fp32)


@pytest.mark.gpu
def test_blur_path_at_1080p_on_the_card():
    """The blur branch and the classical rows on the 1080p clip: the default
    deblur slot is the shipped deblur net and ``unsharp`` resolves to
    itself; one transform launch for the blur, none for the net, one each
    for the unsharp and the Lanczos rows; some blocks blurred and some left
    at 0 rounds; every row uint8 with finite metrics above 25 dB (sharpening
    a noisy clip may lose PSNR against the blurred frames, a broken restorer
    loses tens of dB). On a 2x64x96 crop the net on the card against the
    CPU: in float32 within 1 LSB and 0.01 dB a frame; in its default bf16
    body within 0.25 dB a frame (cuDNN and the CPU kernels round the conv
    sums at different places, see tests/test_torch_blur_slice.py)."""
    from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore import restore_downsample_lanczos
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend

    dev = _cuda()
    cfg = ElvisConfig()
    frames = _clip(dev)
    scores, fg = _score(frames, cfg)
    degraded, levels = adaptive_downsample(frames, scores, B)
    deblur, prov = resolve_deblur_backend(cfg.deblur_backends[0], cfg, device=dev)
    assert prov.startswith("deblur_net:") and prov.endswith("deblur.npz"), prov
    unsharp, prov_u = resolve_deblur_backend("unsharp", cfg, device=dev)
    assert prov_u == "unsharp"
    (blurred, rounds), n_blur = _transforms(
        lambda: adaptive_blur(frames, scores, B, cfg.gaussian_max_rounds))
    out, counts = {}, [n_blur]
    for row, fn in (("deblur_net", lambda: deblur(blurred, rounds, B)),
                    ("unsharp", lambda: unsharp(blurred, rounds, B)),
                    ("lanczos", lambda: restore_downsample_lanczos(degraded, levels, B))):
        out[row], n = _transforms(fn)
        counts.append(n)
    assert counts == [1, 0, 1, 1]
    assert int(rounds.max()) >= 1 and bool((rounds == 0).any())
    for row, frames_out in out.items():
        assert frames_out.shape == frames.shape and frames_out.dtype == torch.uint8, row
    for got in (blurred, degraded):
        assert bool(torch.isfinite(masked_psnr(frames, got)).all())
        assert bool(torch.isfinite(masked_psnr(frames, got, fg)).all())
    for row, got in out.items():
        psnr = masked_psnr(frames, got)
        for v in (psnr, masked_psnr(frames, got, fg), masked_ssim(frames, got)):
            assert bool(torch.isfinite(v).all()), row
        assert psnr.mean().item() > 25.0, row

    crop = frames[:2, :64, :96].contiguous()
    s_card, _ = _score(crop, cfg)
    b_card, r_card = adaptive_blur(crop, s_card, B, cfg.gaussian_max_rounds)
    _, r_cpu = adaptive_blur(crop.cpu(), s_card.cpu(), B, cfg.gaussian_max_rounds)
    cpu_deblur, _ = resolve_deblur_backend(cfg.deblur_backends[0], cfg, device="cpu")
    for dtype, tol_db in ((torch.bfloat16, 0.25), (torch.float32, 0.01)):
        deblur.net.dtype = cpu_deblur.net.dtype = dtype
        n_card, n_cpu = deblur(b_card, r_card, B).cpu(), cpu_deblur(b_card.cpu(), r_cpu, B)
        p_err = (masked_psnr(crop.cpu(), n_card) - masked_psnr(crop.cpu(), n_cpu)).abs().max()
        assert p_err.item() <= tol_db, dtype
        lsb = (n_card.int() - n_cpu.int()).abs().max().item()
        assert dtype != torch.float32 or lsb <= 1, lsb


@pytest.mark.gpu
def test_codec_path_at_1080p_on_the_card(tmp_path):
    """The main path through the NVC codec as the pipeline's downsample
    branch runs it, on the 1080p clip at the default target bitrate (gop
    30), and the baseline row (the clip at the same target): one transform
    launch; every section of the row's stream, the baseline's and the video
    sidecar's written by the native range coder; the npz sidecar brings the
    levels back, the video sidecar (lossy by design) uint8 maps of their
    shape; the header's size; finite metrics, decoded rows above 25 dB, the
    restore no more than 1 dB under the decoded frames; each stream within
    half of the target unless the rate model ran out of QPs (0 or 51)."""
    from elvis_tpu_torch.codec import calculate_target_bitrate, sidecar
    from elvis_tpu_torch.codec.dispatch import make_pipeline_codec
    from elvis_tpu_torch.codec.nvc import codec as nvc
    from elvis_tpu_torch.codec.nvc import entropy
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    dev = _cuda()
    cfg = ElvisConfig()
    frames = _clip(dev)
    fps, gop, duration = 30.0, 30, N / 30.0
    target = cfg.target_bitrate_override or calculate_target_bitrate(W, H, fps,
                                                                     cfg.quality_factor)
    codec = make_pipeline_codec(cfg.codec, "", W, H, quality=cfg.quality_preset,
                                nvc_b_frames=cfg.nvc_b_frames, nvc_me_radius=cfg.nvc_me_radius,
                                nvc_multi_ref=cfg.nvc_multi_ref, nvc_deblock=cfg.nvc_deblock,
                                nvc_intra_pred=cfg.nvc_intra_pred, device=dev)
    restore, _ = resolve_sr_backend(cfg.sr_backends[0], cfg, device=dev)
    enc_kw = dict(target_bitrate=target, framerate=fps, gop=gop)

    def row():
        scores, fg = _score(frames, cfg)
        degraded, levels = adaptive_downsample(frames, scores, B)
        return fg, degraded, levels, codec.encode(degraded, **enc_kw)

    (fg, degraded, levels, stream), n = _transforms(row)
    assert n == 1
    decoded = codec.decode(stream)
    levels_np = levels.cpu().numpy()
    npz, nvsv = str(tmp_path / "maps.npz"), str(tmp_path / "maps.nvsv")
    sidecar.save_strength_maps_npz(levels_np, npz)
    maps_npz = sidecar.load_strength_maps_npz(npz)
    sidecar.save_strength_maps_video(levels_np, nvsv, framerate=fps,
                                     target_bitrate=cfg.strength_maps_target_bitrate, device=dev)
    maps_video = sidecar.load_strength_maps_video(nvsv, device=dev)
    maps = maps_npz if cfg.strength_maps_use_npz else maps_video
    restored = restore(decoded, torch.as_tensor(maps.astype(np.int32), device=dev), B)
    base_stream = codec.encode(frames, **enc_kw)
    base_decoded = codec.decode(base_stream)

    with open(nvsv, "rb") as f:
        sidecar_stream = f.read()[12:]
    for s in (stream, base_stream, sidecar_stream):
        assert all(b == entropy.BACKEND_NATIVE for b in nvc.section_backends(s))
    assert decoded.shape == frames.shape and decoded.dtype == torch.uint8 and decoded.is_cuda
    assert restored.shape == frames.shape and restored.dtype == torch.uint8
    assert np.array_equal(maps_npz, levels_np)
    assert maps_video.shape == levels_np.shape and maps_video.dtype == np.uint8
    info, base_info = codec._codec.probe(stream), codec._codec.probe(base_stream)
    assert (info.width, info.height, info.num_frames) == (W, H, N)
    psnr = {}
    for name, got in (("decoded", decoded), ("restored", restored), ("baseline", base_decoded)):
        vals = (masked_psnr(frames, got), masked_psnr(frames, got, fg), masked_ssim(frames, got))
        assert all(bool(torch.isfinite(v).all()) for v in vals), name
        psnr[name] = vals[0].mean().item()
    assert bool(torch.isfinite(masked_psnr(frames, degraded)).all())
    assert psnr["decoded"] > 25.0 and psnr["baseline"] > 25.0
    assert psnr["restored"] > psnr["decoded"] - 1.0
    for size, q in ((len(stream), info.base_qp), (len(base_stream), base_info.base_qp)):
        assert q in (0, 51) or 0.5 <= size * 8 / (target * duration) <= 1.5, (size, q)


@pytest.mark.gpu
def test_codec_at_1080p_repeats_and_chunks_byte_for_byte():
    """An encode of the 1080p clip at QP 32 (gop 30, the default flags): the
    device half's levels, modes and vectors come back through the stream
    unchanged; the same encode twice gives the same bytes and frames; the
    chunked encode (4 frames a segment) the same bytes. On a 2x128x192 crop
    the card's stream decoded on the card and the CPU's decoded on the CPU
    are within 0.05 dB."""
    from elvis_tpu_torch.codec.nvc import codec as nvc
    from elvis_tpu_torch.metrics import masked_psnr
    from elvis_tpu_torch.pipeline import ElvisConfig

    dev = _cuda()
    cfg = ElvisConfig()
    frames = _clip(dev)
    fps, gop, qp = 30.0, 30, 32
    pad = nvc._pad_to(frames, nvc._PAD)
    hp, wp = pad.shape[1:3]
    qp_map = nvc._qp_maps(N, hp // 8, wp // 8, qp, None)
    qp_y, qp_c = (torch.as_tensor(q, device=dev) for q in (qp_map, nvc._chroma_qp(qp_map)))
    planes_dev, _ = nvc._encode_planes(pad, qp_y, qp_c, gop, cfg.nvc_me_radius, 1, True,
                                       multi_ref=cfg.nvc_multi_ref, deblock=cfg.nvc_deblock,
                                       intra_pred=cfg.nvc_intra_pred)
    planes = nvc._to_host(planes_dev)
    stream = nvc.write_stream(planes, width=W, height=H, qp=qp, framerate=fps, gop=gop,
                              deblock=cfg.nvc_deblock)
    for a, b in zip(planes, nvc.read_stream(stream)[2]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    flags = dict(me_radius=cfg.nvc_me_radius, multi_ref=cfg.nvc_multi_ref,
                 deblock=cfg.nvc_deblock, intra_pred=cfg.nvc_intra_pred)
    again = nvc.encode(frames, qp=qp, framerate=fps, gop=gop, **flags)
    assert again == stream
    assert torch.equal(nvc.decode(again, device=dev)[0], nvc.decode(stream, device=dev)[0])
    assert nvc.encode(frames, qp=qp, framerate=fps, gop=gop, chunk_frames=4, **flags) == stream

    crop = frames[:2, :128, :192].contiguous()
    s_card = nvc.encode(crop, qp=qp, framerate=fps, gop=gop)
    s_cpu = nvc.encode(crop.cpu(), qp=qp, framerate=fps, gop=gop)
    p_card = masked_psnr(crop.cpu(), nvc.decode(s_card, device=dev)[0].cpu()).mean().item()
    p_cpu = masked_psnr(crop.cpu(), nvc.decode(s_cpu, device="cpu")[0]).mean().item()
    assert abs(p_card - p_cpu) <= 0.05


@pytest.fixture(scope="module")
def default_run_1080p(tmp_path_factory):
    """``run_elvis`` with the default config on an 8-frame 1080p synthetic
    clip (what ``python -m elvis_tpu_torch.cli`` runs), then again on the
    same directory: the directory, the first run's results, stats and
    transform launches, and the second run's results."""
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    _cuda()
    exp = tmp_path_factory.mktemp("default_1080p")
    cfg = ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W,
                      height=H, experiment_dir=str(exp))
    stats = {}
    first, launches = _transforms(lambda: run_elvis(cfg, device="cuda", stats=stats))
    return exp, first, stats, launches, run_elvis(cfg, device="cuda")


@pytest.mark.gpu
def test_default_run_at_1080p_on_the_card(default_run_1080p):
    """The nine rows, each with bits and finite metrics, the JSON's keys, the
    sidecars and one saliency mask a frame; the ProPainter and E2FGVI rows'
    fills read the motion hint and have their stage timers and peaks; one
    transform launch per degrade or classical stage (downsample, blur,
    Lanczos, unsharp); the second run takes every stage from the cache and
    gives the same rows (the bitrate equal, each metric within 1e-4
    relative: the classical rows and the evaluation run again)."""
    import json

    exp, first, stats, launches, second = default_run_1080p
    for rel in ("shrink_masks_8.npz", "maps/downsample_maps.npz", "maps/gaussian_maps.npz"):
        assert (exp / rel).is_file(), rel
    assert len(list((exp / "maps" / "saliency_masks").iterdir())) == N
    for stage in ("ProPainter Inpainting", "E2FGVI Inpainting"):
        assert stage in first["execution_times_seconds"] and stage in stats["stage_peak_bytes"]
    provs = first["parameters"]["derived"]["backends"]
    assert all(provs[k].endswith("+motion_hint") for k in PIPELINE_ROWS[3:5]), provs
    assert launches == 4
    written = json.loads((exp / "analysis_results.json").read_text())
    assert set(written) >= {"execution_times_seconds", "video_name", "video_length_seconds",
                            "video_framerate", "video_resolution", "block_size",
                            "target_bitrate_bps", "parameters", "experiment_dir",
                            "analysis_results_path"}
    assert _rows(first) == list(PIPELINE_ROWS)
    assert all(first[row]["bitrate_mbps"] > 0 for row in PIPELINE_ROWS)
    _rows_finite(first)
    assert second["stage_cache"] == {"hits": [
        "scoring", "baseline_encode", "shrink_encode", "roi_encode", "downsample_encode",
        "gaussian_encode", "inpaint_diffusion", "inpaint_temporal", "inpaint_neural",
        "sr_realesrgan", "deblur_deblur_net"], "misses": []}
    apart = _rows_apart(second, first, relative=True)
    assert apart["bitrate_rel"] == 0.0 and all(v <= 1e-4 for v in apart.values()), apart


@pytest.mark.gpu
def test_fills_at_1080p_on_the_shrunk_branch(default_run_1080p):
    """The shrunk branch's decoded and stretched frames of the default run,
    with the removal sidecar's motion hint: the temporal fill (with the hint
    and without), the E2FGVI seed and the net's ``post`` (as stage 8 drives
    it, in height tiles, and in one call) give finite frames of their shape,
    and the temporal fill keeps the known pixels. The temporal fill (window
    1, overlap 2) over 2 and 4 logical shards against one call: known
    pixels bit-equal, at least 99.5% of hole pixels within 1 LSB (the
    scatter adds with float atomics), the last frame within 1 LSB (the
    hint's field has a zero-motion halo edge)."""
    from elvis_tpu_torch.codec.nvc.codec import decode
    from elvis_tpu_torch.codec.sidecar import load_removal_masks_npz
    from elvis_tpu_torch.degrade.removal import stretch_frames
    from elvis_tpu_torch.ops.motion import motion_field_from_hint
    from elvis_tpu_torch.parallel import temporal_map_overlap
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.pipeline.run import _apply_temporal, _carry_tiling
    from elvis_tpu_torch.restore.backends import resolve_inpaint_backend
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal

    exp, _, stats, _, _ = default_run_1080p
    masks, gmv, mdev = load_removal_masks_npz(str(exp / "shrink_masks_8.npz"), with_motion=True)
    assert gmv is not None and mdev is not None
    mask = torch.as_tensor(masks.astype("int8"), device="cuda")
    stretched = stretch_frames(decode(stats["streams"]["shrunk"], device="cuda")[0], mask, B)
    field = motion_field_from_hint(torch.as_tensor(gmv, device="cuda"),
                                   torch.as_tensor(mdev, device="cuda"), H // B, W // B)
    hole = mask.bool().repeat_interleave(B, 1).repeat_interleave(B, 2)
    temporal, _ = resolve_inpaint_backend("temporal", ElvisConfig(), device="cuda")
    neural, _ = resolve_inpaint_backend("neural", ElvisConfig(), device="cuda")
    post = neural.split.post
    seeded = neural.split(stretched, mask, B, mv=field)
    staged = _carry_tiling(lambda f, m: post(f, m, B), post)
    outs = {"temporal, motion hint": temporal(stretched, mask, B, mv=field),
            "temporal, estimated motion": temporal(stretched, mask, B),
            "E2FGVI seed": seeded,
            "net post, as stage 8": _apply_temporal(staged, (seeded, mask),
                                                    overlap=post.temporal_overlap),
            "net post, one call": post(seeded, mask, B)}
    for label, r in outs.items():
        assert r.shape == stretched.shape and bool(torch.isfinite(r.float()).all()), label
    for label in ("temporal, motion hint", "temporal, estimated motion"):
        assert torch.equal(outs[label][~hole], stretched[~hole]), label

    for arrays, call, zero_edge in (
            ((stretched, mask, field),
             lambda f, m, mv: restore_removal_temporal(f, m, B, window=1, motion_field=mv),
             (False, False, True)),
            ((stretched, mask), lambda f, m: restore_removal_temporal(f, m, B, window=1), ())):
        whole = call(*arrays)
        for k in (2, 4):
            got = temporal_map_overlap(call, arrays, _logical_mesh(k), overlap=2,
                                       zero_edge=zero_edge)
            d = (got[hole].int() - whole[hole].int()).abs()
            assert torch.equal(got[~hole], whole[~hole]), (k, len(arrays))
            assert float((d <= 1).float().mean()) >= 0.995, (k, len(arrays))
            assert int((got[-1].int() - whole[-1].int()).abs().max()) <= 1, (k, len(arrays))


@pytest.mark.gpu
def test_sharded_runs_at_1080p_match_the_default_run(default_run_1080p, logical_card,
                                                     tmp_path):
    """``run_elvis`` at the default run's size with ``realesrgan_devices=[0]``
    and ``spatial_devices=2`` on the one card (no mesh: four transform
    launches), then over a logical 2-shard data mesh (six: downsample and
    blur once, Lanczos and unsharp once a shard): the default run's rows
    within the pipeline's row tolerances (bitrate 1%, PSNR 0.1 dB, SSIM 2e-3, LPIPS
    1e-3)."""
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    _, default, _, _, _ = default_run_1080p
    kw = dict(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W, height=H)
    single, launches = _transforms(lambda: run_elvis(ElvisConfig(
        experiment_dir=str(tmp_path / "single"), realesrgan_devices=[0], spatial_devices=2,
        **kw), device="cuda"))
    apart = _rows_apart(single, default)
    assert _rows(single) == list(PIPELINE_ROWS) and all(apart[k] <= v for k, v in
                                                         ROW_TOL.items()), apart
    assert launches == 4
    logical_card(2)
    sharded, launches = _transforms(lambda: run_elvis(ElvisConfig(
        experiment_dir=str(tmp_path / "sharded"), **kw), device="cuda"))
    apart = _rows_apart(sharded, default)
    assert _rows(sharded) == list(PIPELINE_ROWS)
    assert all(apart[k] <= v for k, v in ROW_TOL.items()), apart
    assert launches == 6


@pytest.mark.gpu
def test_every_backend_in_one_run_at_1080p(tmp_path):
    """``run_elvis`` at 8x1080p with every remaining SR, deblur and saliency
    name whose weights ship, and the DCT-dampen branch: eighteen rows with
    finite metrics, the dampen row with bits and its sidecar written, no
    out-of-memory fallback, six transform launches (two degrades,
    'lanczos', 'hybrid', two classical rows). Each of those restorers alone
    on the 1080p clip, as its stage drives it, gives finite values."""
    import warnings

    from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample, dct_dampen
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.pipeline.run import _apply_framewise, _carry_tiling
    from elvis_tpu_torch.restore import RestoreFallbackWarning, restore_dct_dampen_inverse
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend, resolve_sr_backend
    from elvis_tpu_torch.scoring import get_saliency_fn

    dev = _cuda()
    names = dict(sr_backends=["realesrgan", "srnet_large", "srnet_4k", "lanczos", "hybrid",
                              "level_seq", "naive_sr"],
                 deblur_backends=["deblur_net", "diffusion", "naive_diffusion"],
                 enable_dct_dampen=True, saliency_backend="neural")
    cfg = ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W,
                      height=H, experiment_dir=str(tmp_path), **names)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run, launches = _transforms(lambda: run_elvis(cfg, device="cuda"))
    assert (tmp_path / "maps" / "dampen_maps.npz").is_file()
    assert not [w for w in caught if issubclass(w.category, RestoreFallbackWarning)]
    assert launches == 6
    assert _rows(run) == ["Baseline", "PRESLEY QP", "ELVIS v2 Dampen", "ELVIS CV2",
                          "ELVIS ProPainter", "ELVIS E2FGVI", "PRESLEY RealESRGAN",
                          *(f"PRESLEY SR {n}" for n in names["sr_backends"][1:]),
                          "PRESLEY InstantIR",
                          *(f"PRESLEY Deblur {n}" for n in names["deblur_backends"][1:]),
                          "PRESLEY Lanczos", "PRESLEY Unsharp"]
    _rows_finite(run)
    assert run["ELVIS v2 Dampen"]["bitrate_mbps"] > 0

    base = ElvisConfig()
    clip = _clip(dev)
    scores, _ = _score(clip, base)
    blurred, blur_lv = adaptive_blur(clip, scores, B, base.gaussian_max_rounds)
    down, down_lv = adaptive_downsample(clip, scores, B)
    damped, damp_lv = dct_dampen(clip, scores, B)

    def staged(fn, f, m):
        return _apply_framewise(_carry_tiling(lambda a, b: fn(a, b, B), fn), f, m)

    diffusion, _ = resolve_deblur_backend("diffusion", base, device="cuda")
    outs = [staged(diffusion, blurred, blur_lv), get_saliency_fn("neural")(clip), damped,
            restore_dct_dampen_inverse(damped, damp_lv, B)]
    for n in ("srnet_large", "level_seq", "naive_sr"):
        outs.append(staged(resolve_sr_backend(n, base, device="cuda")[0], down, down_lv))
    assert all(bool(torch.isfinite(out.float()).all()) for out in outs)


def _argv_lines(fake):
    import json

    with open(fake / "argv.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.gpu
def test_external_encoders_at_1080p_under_the_codec_shim(tmp_path, monkeypatch):
    """No encoder binary exists on the card's machine, so the codec shim
    records each argv and stashes its input losslessly. ``run_elvis`` at
    8x1080p through x265 (preset 'slow') with the RRDB tier and the
    ensemble beside the generic slot: eleven rows with finite metrics, four
    transform launches, 5 encodes x 2 passes with the qpfile (8 lines of
    68x120 CTUs) and ``ctu=16`` on the ROI encode's pass 2. kvazaar and
    SVT-AV1 through their pipeline codecs on the 1080p clip: the stash comes
    back whole, the QP / CRF on the argv is the rate model's; the rate
    model's QP on a 256x512 crop within 1 of the CPU's."""
    from elvis_tpu_torch.codec.dispatch import _RateModel, make_pipeline_codec
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    dev = _cuda()
    fake = tmp_path / "fake"
    fake.mkdir()
    monkeypatch.setenv("ELVIS_TPU_FAKE_CODECS", str(fake))
    exp = tmp_path / "exp"
    cfg = ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W,
                      height=H, experiment_dir=str(exp), codec="x265", encode_preset="slow",
                      sr_backends=["realesrgan", "srnet", "srnet_ensemble"])
    run, launches = _transforms(lambda: run_elvis(cfg, device="cuda"))
    argv = _argv_lines(fake)
    qpfiles = sorted((exp / "codec").glob("*.qpfile"))
    assert len(qpfiles) == 1, qpfiles
    assert run["parameters"]["derived"]["codec"] == "x265"
    assert launches == 4
    assert len(argv) == 10 and all(a[0] == "ffmpeg" for a in argv)
    params = [a[a.index("-x265-params") + 1] for a in argv]
    assert [i for i, x in enumerate(params) if "qpfile=" in x] == [5]
    assert "ctu=16" in params[5] and "ctu=16" in params[4]
    assert all(a[a.index("-preset") + 1] == "slow" for a in argv)
    assert all("pass=1" in params[i] and "pass=2" in params[i + 1] for i in range(0, 10, 2))
    assert _rows(run) == [*PIPELINE_ROWS[:6], "PRESLEY SR srnet", "PRESLEY SR srnet_ensemble",
                          *PIPELINE_ROWS[6:]]
    _rows_finite(run)
    lines = qpfiles[0].read_text().splitlines()
    ctus = math.ceil(H / 16) * math.ceil(W / 16)
    assert len(lines) == N and all(len(x.split(" ")) == 3 + ctus for x in lines)

    clip = _clip(dev)
    sc = _score(clip, ElvisConfig())[0].cpu().numpy()
    target = run["target_bitrate_bps"]
    for name, flag, chain_len in (("kvazaar", "-q", 3), ("svtav1", "--crf", 2)):
        codec = make_pipeline_codec(name, str(tmp_path / name), W, H, device="cuda")
        before = len(_argv_lines(fake))
        stream = codec.encode_roi(clip, removability=sc, importance=1.0 - sc, block_size=B,
                                  roi_qp_range=15, target_bitrate=target, framerate=30.0, gop=30)
        assert torch.equal(codec.decode(stream), clip), name
        chain = _argv_lines(fake)[before:]
        pick = codec._rate.hevc_qp if name == "kvazaar" else codec._rate.av1_crf
        q = pick(clip, target, 30.0)
        assert len(chain) == chain_len and chain[0][chain[0].index(flag) + 1] == str(q), chain
    (rows, cols), _ = _centre(clip.shape, *CROP)
    small_target = int(target * CROP[0] * CROP[1] / (H * W))
    qp_card = _RateModel("cuda").hevc_qp(clip[:, rows, cols], small_target, 30.0)
    qp_cpu = _RateModel("cpu").hevc_qp(clip[:, rows, cols].cpu(), small_target, 30.0)
    assert abs(qp_card - qp_cpu) <= 1, (qp_card, qp_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["srnet", "srnet_ensemble"])
def test_rrdb_and_ensemble_on_a_1080p_crop_match_cpu(name):
    """The RRDB tier and the ensemble on a 2x128x256 centre crop of the
    1080p clip's degraded frames, card against CPU: uint8 within 1 LSB and
    0.1 LSB on average, restored PSNR within 0.05 dB."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.metrics import masked_psnr
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    dev = _cuda()
    clip = _clip(dev)
    down, down_lv = adaptive_downsample(clip, _score(clip, ElvisConfig())[0], B)
    (rows, cols), (brows, bcols) = _centre(clip.shape, *SR_CROP)
    c_down, c_lv, ref = down[:2, rows, cols], down_lv[:2, brows, bcols], clip[:2, rows, cols].cpu()
    card_fn, _ = resolve_sr_backend(name, ElvisConfig(), device=dev)
    cpu_fn, _ = resolve_sr_backend(name, ElvisConfig(), device="cpu")
    g_card = card_fn(c_down, c_lv, B).cpu()
    g_cpu = cpu_fn(c_down.cpu(), c_lv.cpu(), B)
    lsb = (g_card.int() - g_cpu.int()).abs()
    assert int(lsb.max()) <= 1 and float(lsb.float().mean()) <= 0.1
    assert float((masked_psnr(ref, g_card) - masked_psnr(ref, g_cpu)).abs().max()) <= 0.05


@pytest.mark.gpu
def test_presley_at_its_defaults_on_the_card(tmp_path):
    """``run_presley`` at ``PresleyConfig()``'s defaults (1280x720, 20
    frames, block 16, both shrink methods): seventeen rows, all ``ok`` with
    finite metrics, the JSON written with the same rows, seven transform
    launches (three degrades, 'lanczos', 'lanczos_tb', scale-Lanczos,
    unsharp)."""
    import json

    from elvis_tpu_torch.presley import PresleyConfig, run_presley

    _cuda()
    cfg = PresleyConfig(output_dir=str(tmp_path))
    res, launches = _transforms(lambda: run_presley(cfg, device="cuda"))
    written = json.loads((tmp_path / "performance_metrics.json").read_text())
    methods = res["methods"]
    assert len(methods) == 14 + 3 * (len(cfg.shrink_methods) - 1) == 17
    assert list(written["methods"]) == list(methods)
    for row, r in methods.items():
        assert r["status"] == "ok", (row, r.get("error"))
        assert all(np.isfinite(v) for v in r["metrics"].values()), (row, r["metrics"])
    assert launches == 7


def _presley_rows_apart(a, b, skip=()):
    """Largest difference of each metric over two run_presley results' rows
    (but ``skip``): relative for the bytes and the MSE, absolute for the
    rest."""
    worst = {}
    for row, rb in b["methods"].items():
        if row in skip:
            continue
        ra = a["methods"][row]
        if "size_bytes" in rb:
            worst["bytes_rel"] = max(worst.get("bytes_rel", 0.0),
                                     abs(ra["size_bytes"] - rb["size_bytes"]) / rb["size_bytes"])
        for key, vb in rb["metrics"].items():
            d = abs(ra["metrics"][key] - vb)
            worst[key] = max(worst.get(key, 0.0), d / vb if key == "mse" else d)
    return worst


@pytest.mark.gpu
def test_presley_on_card_matches_cpu(tmp_path):
    """``run_presley`` at 6x96x64 on the card and on the CPU: the same rows,
    all ``ok``, within the pipeline's row tolerances (bytes 1%, PSNR 0.1 dB,
    SSIM 2e-3, MSE 1%). The diffusion row draws its noise from each
    device's generator, so it is held to twice the CPU's own range over
    three seeds where that is larger."""
    from elvis_tpu_torch.presley import PresleyConfig, run_presley

    _cuda()
    small = dict(reference_video="synthetic://moving?frames=6", width=96, height=64,
                 max_frames=6, save_intermediate=False)
    card = run_presley(PresleyConfig(output_dir=str(tmp_path / "card"), **small), device="cuda")
    cpu = {seed: run_presley(PresleyConfig(output_dir=str(tmp_path / f"cpu{seed}"),
                                           instantir_seed=seed, **small), device="cpu")
           for seed in (42, 43, 44)}
    diff_row = "blur_instantir_adaptive"
    assert list(card["methods"]) == list(cpu[42]["methods"])
    assert all(r["status"] == "ok" for r in card["methods"].values())
    worst = _presley_rows_apart(card, cpu[42], skip=(diff_row,))
    tol = {"psnr": 0.1, "fg_psnr": 0.1, "bg_psnr": 0.1, "ssim": 2e-3, "mse": 0.01}
    assert worst["bytes_rel"] <= 0.01 and all(worst[k] <= t for k, t in tol.items()), worst
    seeds = [cpu[s]["methods"][diff_row]["metrics"] for s in cpu]
    spread = {k: max(m[k] for m in seeds) - min(m[k] for m in seeds) for k in seeds[0]}
    d_card = card["methods"][diff_row]["metrics"]
    d_worst = {k: abs(d_card[k] - seeds[0][k]) for k in d_card}
    assert all(d_worst[k] <= max(t * (seeds[0][k] if k == "mse" else 1), 2 * spread[k])
               for k, t in tol.items()), d_worst


@pytest.mark.gpu
def test_height_tiled_restore_at_2160p_matches_whole_frames():
    """The default SR slot's restore of 4 frames of 2160p in 3 height tiles
    of whole blocks (a data 1 x spatial 3 logical mesh, a 64-row halo, the
    config's; 4 tiles of 540 rows are not whole blocks) against the whole
    frames: within 1 LSB on at most 0.5% of the pixels."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.parallel import spatial_tile_map_blocks
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    dev = _cuda()
    cfg = ElvisConfig()
    n, h, w = 4, 2160, 3840
    assert h >= cfg.spatial_tile_threshold
    clip = _clip(dev, n, h, w)
    degraded, levels = adaptive_downsample(clip, _score(clip, cfg)[0], B)
    restore, _ = resolve_sr_backend("realesrgan", cfg, device=dev)
    mesh = _logical_mesh(3, (("data", 1), ("spatial", 3)))
    tiled = spatial_tile_map_blocks(lambda f, lv: restore(f, lv, B), degraded, levels, mesh,
                                    64, B, data_axis="data")
    d = (tiled.int() - restore(degraded, levels, B).int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 5e-3


STUDENT = dict(features=256, num_convs=6, batch=16, patch=64)  # as train_srnet_student takes it
STEP_LR = 1e-4  # the sharded and card-vs-CPU step checks: constant learning rate


def _student_batches(dev):
    """A held-out batch and two training batches of the student's natural
    patches (clean, degraded, levels), from one generator seeded 7."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.train.data import natural_frames

    gen = torch.Generator(device=dev).manual_seed(7)
    side, out = STUDENT["patch"] // B, []
    for _ in range(3):
        clean = natural_frames(gen, STUDENT["batch"], STUDENT["patch"], STUDENT["patch"])
        out.append((clean, *adaptive_downsample(
            clean, torch.rand((STUDENT["batch"], side, side), generator=gen, device=dev), B)))
    return out[0], out[1:]


def _sr_steps(mesh, dtype, batches, device, state):
    """One AdamW step (constant learning rate) per batch of an SRNetCompact
    at the student's widths from ``state``: the parameters on the CPU and
    the losses."""
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train import trainer as ttrainer
    from elvis_tpu_torch.train.cli import MAX_LEVEL

    model = SRNetCompact(STUDENT["features"], STUDENT["num_convs"], dtype=dtype)
    model.load_state_dict(state)
    model.to(device)

    def loss_fn(p, data):
        up = lambda f: torch.func.functional_call(model, p, (f,))  # noqa: E731
        out = progressive_restore(data[1], data[2], B, upsample_fn=up, max_level=MAX_LEVEL)
        return torch.mean((out - data[0]) ** 2) / 255.0**2

    t = ttrainer.Trainer(loss_fn, model, mesh=mesh, learning_rate=STEP_LR, device=device)
    losses = [float(t.step(tuple(x.to(device) for x in b))) for b in batches]
    return t.params(torch.device("cpu")), losses


def _params_apart(got, want, start):
    """Adam moves a weight by up to the learning rate whatever its gradient's
    size, so a near-zero gradient's rounding (cuDNN picks its algorithms by
    batch) can move one weight apart: per tensor, the mean distance against
    the mean move, and the largest distance."""
    return {"mean_over_move": max(float((got[n] - want[n]).abs().mean()) / max(
                float((want[n] - start[n]).abs().mean()), 1e-12) for n in want),
            "max_param_apart": max(float((got[n] - want[n]).abs().max()) for n in want)}


@pytest.mark.gpu
def test_student_trains_at_its_shipped_architecture(tmp_path, monkeypatch):
    """``train_srnet_student`` at 256 x 6 (batch 16, patch 64, the three
    teachers, procedural data) for 100 steps at lr 1e-3: finite losses, the
    held-out ground-truth loss lower at the end than after warm-up, one
    transform launch a step; the checkpoint through ``resolve_sr_backend``
    names its tier and restores as the trained module. Two float32 steps of
    the trained student on logical data 2 and data 2 x tensor 2 meshes
    against one device (deterministic cuDNN): the mean distance within 1%
    of the mean move, the largest within a quarter of the summed learning
    rate, the losses within 1e-5 relative."""
    from elvis_tpu_torch.device import full_fp32
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.parallel import make_mesh
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train import trainer as ttrainer
    from elvis_tpu_torch.train.cli import MAX_LEVEL, train_srnet_student

    dev = _cuda()
    steps, warm, snaps = 100, 11, {}
    real_step = ttrainer.Trainer.step

    def step_and_snap(self, batch):  # the parameters right after warm-up
        loss = real_step(self, batch)
        if self.state.step == warm:
            snaps["warm"] = {k: v.clone() for k, v in self.params().items()}
        return loss

    (held_clean, held_deg, held_lv), batches = _student_batches(dev)

    def held_loss(model, params):
        up = lambda f: torch.func.functional_call(model, params, (f,))  # noqa: E731
        with torch.no_grad():
            out = progressive_restore(held_deg, held_lv, B, upsample_fn=up, max_level=MAX_LEVEL)
        return float(torch.mean((out - held_clean) ** 2) / 255.0**2)

    monkeypatch.setattr(ttrainer.Trainer, "step", step_and_snap)
    tr, launches = _transforms(lambda: train_srnet_student(
        steps, str(tmp_path), lr=1e-3, photo_fraction=0.0, device=dev, log_every=10, **STUDENT))
    monkeypatch.undo()
    path = str(tmp_path / "srnet_student.npz")
    fn, prov = resolve_sr_backend("srnet_student", ElvisConfig(srnet_params_path=path),
                                  device=dev)
    via_backend = fn(held_deg, held_lv, B)
    with torch.no_grad():
        via_module = progressive_restore(held_deg, held_lv, B,
                                         upsample_fn=srnet_upsample_fn(tr.model))
    assert all(math.isfinite(x) for x in tr.losses)
    assert held_loss(tr.model, tr.params()) < held_loss(tr.model, snaps["warm"])
    assert launches == steps
    assert prov == f"progressive_neural[srnet_student:{path}]"
    assert torch.equal(via_backend, via_module)

    trained, start = tr.model.state_dict(), {k: v.cpu() for k, v in tr.params().items()}
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with full_fp32():
            one, one_losses = _sr_steps(make_mesh(devices=[0], device_type="cuda"),
                                        torch.float32, batches, dev, trained)
            for k, axes in ((2, (("data", 2),)), (4, (("data", 2), ("tensor", 2)))):
                got, got_losses = _sr_steps(_logical_mesh(k, axes), torch.float32, batches,
                                            dev, trained)
                apart = _params_apart(got, one, start)
                assert apart["mean_over_move"] <= 0.01, (axes, apart)
                assert apart["max_param_apart"] <= 0.25 * 2 * STEP_LR, (axes, apart)
                assert max(abs(a - b) / b for a, b in zip(got_losses, one_losses)) <= 1e-5
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


@pytest.mark.gpu
def test_bf16_student_steps_on_the_card_match_the_cpu():
    """Two bf16 steps of the shipped ``srnet_student`` (the same start in
    every run) on a 4 x 32 x 32 crop of the training batches, card against
    CPU: the mean distance within 15% of the mean move, no tensor with more
    than the larger of 2 and 5% of its elements beyond a quarter of the
    summed learning rate, the losses within 1e-2 relative (the bf16 trunks
    round differently). Negative control: the card's ``up.bias`` put back
    where it started fails the same statistic."""
    from _steps_apart import tensors_moved_apart
    from elvis_tpu_torch.models.io import load_srnet, weights_path
    from elvis_tpu_torch.parallel import make_mesh

    dev = _cuda()
    _, batches = _student_batches(dev)
    shipped = load_srnet(weights_path("srnet_student"), device="cpu").state_dict()
    crop = [tuple(x[:4, : x.shape[1] // 2, : x.shape[2] // 2] for x in b) for b in batches]
    card, card_losses = _sr_steps(make_mesh(devices=[0], device_type="cuda"), torch.bfloat16,
                                  crop, dev, shipped)
    cpu, cpu_losses = _sr_steps(make_mesh(devices=[0], device_type="cpu"), torch.bfloat16,
                                [tuple(x.cpu() for x in b) for b in crop], torch.device("cpu"),
                                shipped)
    limit = 0.25 * 2 * STEP_LR
    _, failing = tensors_moved_apart(card, cpu, limit)
    _, control_failing = tensors_moved_apart(dict(card, **{"up.bias": shipped["up.bias"]}), cpu,
                                             limit)
    assert "up.bias" in control_failing
    assert _params_apart(card, cpu, shipped)["mean_over_move"] <= 0.15 and not failing, failing
    assert max(abs(a - b) / b for a, b in zip(card_losses, cpu_losses)) <= 1e-2


@pytest.mark.gpu
def test_deblur_and_srnet_4k_train_on_the_card(tmp_path):
    """``train_deblur`` at its defaults and ``train_srnet_4k`` (64 x 5 over
    the frozen ``srnet_compact``), 5 steps each: finite losses, one
    transform launch a step; the deblur checkpoint keeps ``max_strength``
    10."""
    from elvis_tpu_torch.models.io import load_deblur
    from elvis_tpu_torch.train.cli import train_deblur, train_srnet_4k

    dev = _cuda()
    for call in (lambda: train_deblur(5, str(tmp_path), device=dev, log_every=100),
                 lambda: train_srnet_4k(5, str(tmp_path), photo_fraction=0.0, device=dev,
                                        log_every=100)):
        tr, launches = _transforms(call)
        assert all(math.isfinite(x) for x in tr.losses) and launches == 5
    assert load_deblur(str(tmp_path / "deblur.npz"), device=dev).max_strength == 10.0


@pytest.mark.gpu
def test_rd_sweep_at_1080p_on_the_card():
    """``rd_sweep`` on the 8-frame 1080p synthetic clip at QPs 26, 38 and
    51: one point a QP on each curve, and more bits give more PSNR."""
    from elvis_tpu_torch.search import rd_curve

    dev = _cuda()
    curves = rd_curve.rd_sweep(f"synthetic://moving?frames={N}", W, H, B, qps=(26, 38, 51),
                               device=dev)
    for label, pts in curves.items():
        assert sorted(p["qp"] for p in pts) == [26, 38, 51], label
        by_bits = sorted(pts, key=lambda p: p["kbps"])
        assert all(a["psnr"] < b["psnr"] for a, b in zip(by_bits, by_bits[1:])), (label, by_bits)


@pytest.mark.gpu
def test_searches_on_the_card_match_direct_runs(tmp_path):
    """``grid_search`` and ``random_search`` over two default runs at
    640x360 (shrink 0.25 and 0.5): every run ``ok``, its rows those of a
    direct ``run_elvis`` of its overrides within the pipeline's row tolerances; then
    ``cleanup_results`` leaves only JSON and PNG files."""
    import importlib

    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.search import cleanup, grid

    rsearch = importlib.import_module("elvis_tpu_torch.search.random_search")
    dev = _cuda()
    video = f"synthetic://moving?frames={N}&fps=30"
    space = {"reference_video": [video], "width": [640], "height": [360],
             "shrink_amount": [0.25, 0.5]}
    summaries = {"grid": grid.grid_search(space, str(tmp_path / "grid"), device=dev),
                 "random": rsearch.random_search(space, runs=2, seed=0,
                                                 results_dir=str(tmp_path / "random"),
                                                 device=dev)}
    direct = {a: run_elvis(ElvisConfig(reference_video=video, width=640, height=360,
                                       shrink_amount=a, experiment_dir=str(tmp_path / f"d{a}")),
                           device=dev) for a in space["shrink_amount"]}
    for name, summary in summaries.items():
        assert len(summary) == 2 and all(r["status"] == "ok" for r in summary), summary
        for r in summary:
            want = direct[r["overrides"]["shrink_amount"]]
            assert _rows(r["metrics"]) == _rows(want), (name, r["slug"])
            apart = _rows_apart(r["metrics"], want)
            assert all(apart[k] <= v for k, v in ROW_TOL.items()), (name, r["slug"], apart)
        cleanup.cleanup_results(str(tmp_path / name))
        left = [f for f in (tmp_path / name).rglob("*")
                if f.is_file() and not f.name.endswith((".json", ".png"))]
        assert not left, left[:5]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["diffusion", "inpaint", "saliency", "perceptual"])
def test_trainers_at_their_defaults_load_back_on_the_card(name, tmp_path):
    """Each of the diffusion, inpaint, saliency and perceptual trainers at
    its defaults for 5 steps (procedural data): finite losses, and the
    checkpoint through its loader runs the trained module's forward."""
    from elvis_tpu_torch.metrics.perceptual import load_perceptual
    from elvis_tpu_torch.models import DiffusionRestorer
    from elvis_tpu_torch.models.io import load_diffusion, load_inpaint, load_saliency
    from elvis_tpu_torch.train import cli

    dev = _cuda()
    tr = getattr(cli, f"train_{name}")(5, str(tmp_path), photo_fraction=0.0, device=dev,
                                       log_every=100)
    assert all(math.isfinite(x) for x in tr.losses)
    path = str(tmp_path / f"{name}.npz")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((8, 64, 64, 3), generator=gen, device=dev) * 255
    with torch.no_grad():
        if name == "diffusion":
            ref = DiffusionRestorer().to(dev)
            ref.unet.load_state_dict(tr.params())
            assert torch.equal(load_diffusion(path, dev).sample(x, steps=2), ref.sample(x, steps=2))
        elif name == "inpaint":
            mask = (torch.rand((8, 8, 8), generator=gen, device=dev) < 0.25).to(torch.int8)
            assert torch.equal(load_inpaint(path, dev)(x, mask, B), tr.model(x, mask, B))
        elif name == "saliency":
            assert torch.equal(load_saliency(path, dev)(x), tr.model(x))
        else:
            assert all(torch.equal(a, b) for a, b in zip(load_perceptual(path, dev)(x),
                                                          tr.model(x)))


@pytest.mark.gpu
def test_holdout_evaluators_and_graft_entry_on_the_card():
    """``sr_holdout_eval`` with the shipped student and
    ``deblur_holdout_eval`` with the shipped deblur net at their defaults:
    the procedural families run (the photo family drops out without PIL)
    and every number is finite. ``graft_entry.entry()``'s forward on the
    card, and ``dryrun_multichip(2)`` on logical shards of it."""
    from elvis_tpu_torch.graft_entry import dryrun_multichip, entry
    from elvis_tpu_torch.models.io import load_deblur, load_srnet, weights_path
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.train import evaluate

    dev = _cuda()
    sr = evaluate.sr_holdout_eval(srnet_upsample_fn(load_srnet(weights_path("srnet_student"),
                                                               dev)), device=dev)
    deblur = load_deblur(weights_path("deblur"), dev)
    db = evaluate.deblur_holdout_eval(lambda f, lv, b: deblur(f, lv, b), device=dev)
    assert all(math.isfinite(v) for r in (*sr.values(), *db.values()) for v in r.values())
    assert {"leaves", "legacy"} <= set(db) and {"leaves_codec", "legacy_codec"} <= set(sr)
    fn, (params, x) = entry(device=dev)
    y = fn(params, x)
    assert tuple(y.shape) == (2, 256, 256, 3) and bool(torch.isfinite(y).all())
    assert dryrun_multichip(2, device=dev)["logical"]
