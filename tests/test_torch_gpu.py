"""Card-only checks of the port's two CUDA kernels (marker ``gpu``).

They skip where no CUDA device is present. This file imports no JAX, so
on a machine with a card and no JAX it runs without the repo's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerance: the kernel and the plain version both compute in float32
without TF32 and differ only in summation order, so ``atol=1e-3`` on 0-255
data (the JAX package's kernel tolerance).
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
