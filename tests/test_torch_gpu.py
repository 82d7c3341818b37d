"""Card-only checks of the port (marker ``gpu``): its two CUDA kernels (the
transform kernel in its block and frame layouts, and the batched kernel),
and the NVC codec on the card against the CPU.

They skip where no CUDA device is present. This file imports no JAX, so
on a machine with a card and no JAX it runs without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerance: the kernel and the plain version both compute in float32
without TF32 and differ only in summation order, so ``atol=1e-3`` on 0-255
data (the JAX package's kernel tolerance). uint8 frames may differ by
1 LSB where a value lands within that distance of a .5 tie; on random data
that is rare, and the tests bound the share of such pixels.
"""

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
    assert torch.equal(tt._level_bits(mags.to(dev)).cpu(), tt._level_bits(mags))


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
