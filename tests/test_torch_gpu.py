"""Card-only checks of the port (marker ``gpu``): its two CUDA kernels (the
transform kernel in its block and frame layouts, and the batched kernel),
the NVC codec, the fills and the pipeline on the card against the CPU, the
halo functions and ``run_elvis`` on logical shards of the card, the
trainer's steps on the card against the CPU and against themselves, and
the dense library route of the transform against its kernel.

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
    (max abs; the card read 0.46 on this clip, 0.38 on chip_smoke.py's
    crop); the residual is real, its mean over the holes above that bound
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
# the same noise, grey levels (as chip_smoke.py phase 8 holds it). The card
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
    main path's crop check in chip_smoke.py)."""
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
    bounds of the SR crop checks in chip_smoke.py)."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 16, 32])
def test_roi_files_on_card_match_cpu(b, tmp_path):
    """The ROI writers regridding on the card against the CPU at 1080p: the
    same CTU and tokens, qpfile values within 1e-4, kvazaar bytes equal, the
    SVT-AV1 segments within one level."""
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
