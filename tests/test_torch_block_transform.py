"""Port parity: the per-block matrix transform.

The port's plain version (the CPU path of ``apply_block_matrix_fast``) is
held to the JAX einsum reference and to the two TPU kernels
``apply_block_matrix_pallas_kron`` and ``apply_block_matrix_pallas`` run in
interpret mode, at ``atol=1e-3`` on 0-255 data — the JAX package's own
kernel tolerance (tests/test_kernels.py). Levels outside ``[0, L)`` are held
to the JAX einsum reference (a negative level wraps once, the rest is
clamped); the TPU kernels' mask-selects give a zero operator there, which
the port does not reproduce. The gradient is held to ``jax.grad`` of
``apply_block_matrix_fast`` at ``rtol=1e-3, atol=1e-2`` (the same test's
tolerance for the linear-op VJP). The CUDA kernels themselves are checked by the
``gpu``-marked tests, on a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.kernels import block_transform as jbt
from elvis_tpu.restore import unsharp as junsharp
from elvis_tpu_torch.kernels import block_transform as tbt
from elvis_tpu_torch.restore import unsharp as tunsharp

ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _table(kind, b):
    if kind == "resample":
        return jbt.resample_matrix_table(b, "linear")
    if kind == "blur":
        return jbt.blur_matrix_table(b, 10)
    if kind == "unsharp":
        return junsharp._unsharp_blur_table(b, 10)
    return jbt.resample_matrix_table(b, "lanczos4")


def _data(rng, m, b, c, ell):
    blocks = (rng.random((m, b, b, c)) * 255).astype(np.float32)
    idx = rng.integers(0, ell, (m,)).astype(np.int32)
    return blocks, idx


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("kind", ["resample", "blur", "lanczos"])
def test_host_tables_exact(b, kind):
    want = _table(kind, b)
    got = {"resample": lambda: tbt.resample_matrix_table(b, "linear"),
           "blur": lambda: tbt.blur_matrix_table(b, 10),
           "lanczos": lambda: tbt.resample_matrix_table(b, "lanczos4")}[kind]()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbt.conv_matrix_reflect101(b), jbt.conv_matrix_reflect101(b))


# (b, L): the main path's resample table (b=8, L=4), the blur table (b=8,
# L=11), and b=16 tables (L=5 resample, L=11 blur)
@pytest.mark.parametrize("b,kind", [(8, "resample"), (8, "blur"), (16, "lanczos"),
                                    (16, "blur")])
def test_plain_matches_einsum_and_pallas_kron(rng, b, kind):
    table = _table(kind, b)
    ell = table.shape[0]
    blocks, idx = _data(rng, 70, b, 3, ell)
    want = np.asarray(jbt.apply_block_matrix(jnp.asarray(blocks), jnp.asarray(table, jnp.float32),
                                             jnp.asarray(idx)))
    kron = np.asarray(jbt.apply_block_matrix_pallas_kron(
        jnp.asarray(blocks), table, jnp.asarray(idx), tile=32, interpret=True))
    t = torch.as_tensor(table, dtype=torch.float32)
    got = tbt.apply_block_matrix(torch.from_numpy(blocks), t, torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, kron, atol=ATOL)
    fast = tbt.apply_block_matrix_fast(torch.from_numpy(blocks), table, torch.from_numpy(idx))
    np.testing.assert_allclose(fast.numpy(), want, atol=ATOL)


# the batched-small TPU kernel, at the tables of the blur branch and the
# classical rows; M*C is no multiple of its tile of 32
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("b,kind", [(8, "blur"), (8, "unsharp"), (8, "lanczos"),
                                    (16, "blur"), (16, "unsharp"), (16, "lanczos")])
def test_plain_matches_pallas_batched(rng, b, kind, c):
    table = _table(kind, b)
    m = 37
    blocks, idx = _data(rng, m, b, c, table.shape[0])
    assert (m * c) % 32
    pallas = np.asarray(jbt.apply_block_matrix_pallas(
        jnp.asarray(blocks), table, jnp.asarray(idx), tile=32, interpret=True))
    t = torch.as_tensor(table, dtype=torch.float32)
    got = tbt.apply_block_matrix(torch.from_numpy(blocks), t, torch.from_numpy(idx)).numpy()
    assert got.shape == pallas.shape == (m, b, b, c)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("b", [8, 16])
def test_unsharp_table_exact(b):
    """Level 10 is sigma 10: 61 taps folded into the block by the
    reflect-101 bounce."""
    assert tunsharp._auto_ksize(10.0) == junsharp._auto_ksize(10.0) == 61
    np.testing.assert_array_equal(tunsharp._unsharp_blur_table(b, 10),
                                  junsharp._unsharp_blur_table(b, 10))


@pytest.mark.parametrize("kind", ["resample", "blur"])
def test_out_of_range_levels_follow_the_jax_reference(rng, kind):
    """idx in {-1, -L-1, L, L+5} beside in-range levels: -1 wraps to L-1,
    -L-1 wraps to -1 and is clamped to 0, L and L+5 are clamped to L-1."""
    table = _table(kind, 8)
    ell = table.shape[0]
    idx = np.array([-1, -ell - 1, ell, ell + 5, 0, ell - 1, 1, -ell], np.int32)
    blocks = (rng.random((idx.size, 8, 8, 3)) * 255).astype(np.float32)
    want = np.asarray(jbt.apply_block_matrix(jnp.asarray(blocks), jnp.asarray(table, jnp.float32),
                                             jnp.asarray(idx)))
    t = torch.as_tensor(table, dtype=torch.float32)
    got = tbt.apply_block_matrix(torch.from_numpy(blocks), t, torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and they are the in-range entries the rule names
    same = np.array([ell - 1, 0, ell - 1, ell - 1, 0, ell - 1, 1, 0], np.int32)
    ref = tbt.apply_block_matrix(torch.from_numpy(blocks), t, torch.from_numpy(same)).numpy()
    np.testing.assert_array_equal(got, ref)
    fast = tbt.apply_block_matrix_fast(torch.from_numpy(blocks), table, torch.from_numpy(idx))
    np.testing.assert_array_equal(fast.numpy(), got)


def test_fast_multi_dim_lead(rng):
    """(N, By, Bx, b, b, C) blocks with (N, By, Bx) levels."""
    table = _table("resample", 8)
    blocks, idx = _data(rng, 60, 8, 3, 4)
    b6, i3 = blocks.reshape(2, 5, 6, 8, 8, 3), idx.reshape(2, 5, 6)
    want = np.asarray(jbt.apply_block_matrix_fast(jnp.asarray(b6), table, jnp.asarray(i3)))
    got = tbt.apply_block_matrix_fast(torch.from_numpy(b6), table, torch.from_numpy(i3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_backward_matches_jax_grad(rng):
    table = _table("blur", 8)
    blocks, idx = _data(rng, 24, 8, 3, table.shape[0])

    def jloss(x):
        return jnp.sum(jbt.apply_block_matrix_fast(x, table, jnp.asarray(idx)) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(blocks)))
    x = torch.from_numpy(blocks).requires_grad_(True)
    (tbt.apply_block_matrix_fast(x, table, torch.from_numpy(idx)) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-3, atol=1e-2)


def test_cuda_wrapper_rejects_cpu_tensors(rng):
    """The CUDA wrapper never computes on the CPU: it raises."""
    blocks, idx = _data(rng, 4, 8, 3, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tbt.apply_block_matrix_cuda(torch.from_numpy(blocks),
                                    torch.as_tensor(_table("resample", 8), dtype=torch.float32),
                                    torch.from_numpy(idx))


def test_batched_cuda_wrapper_rejects_cpu_tensors(rng):
    blocks, idx = _data(rng, 4, 8, 3, 4)
    before = tbt.LAUNCHES["block_transform_batched"]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tbt.apply_block_matrix_batched_cuda(
            torch.from_numpy(blocks), torch.as_tensor(_table("resample", 8), dtype=torch.float32),
            torch.from_numpy(idx))
    assert tbt.LAUNCHES["block_transform_batched"] == before


def test_cpu_path_launches_no_kernel(rng):
    before = tbt.LAUNCHES["block_transform"]
    blocks, idx = _data(rng, 4, 8, 3, 4)
    tbt.apply_block_matrix_fast(torch.from_numpy(blocks), _table("resample", 8),
                                torch.from_numpy(idx))
    assert tbt.LAUNCHES["block_transform"] == before


@pytest.mark.parametrize("b,c", [(8, 3), (16, 3), (8, 1)])
def test_group_size_fits_shared_memory(b, c):
    """The kernel's per-CTA tile (table + X + Y + levels) stays within the
    48 KB a launch may take without opting in to more."""
    for ell in (1, 4, 11, 16):
        g = tbt._group_size(b, c, ell)
        assert g >= 1
        assert (ell * b * b + 2 * g * b * b * c) * 4 + 4 * g <= 48 * 1024


@pytest.mark.parametrize("b,c", [(8, 1), (8, 3), (8, 4), (16, 1), (16, 3), (16, 4)])
def test_batched_group_size_fits_shared_memory(b, c):
    """The batched kernel's per-CTA tile (padded table + one tile of blocks)
    stays within the 48 KB a launch may take without opting in to more."""
    g = tbt._batched_group_size(b, c)
    assert g >= 1
    assert (16 * (b * b + 4) + g * b * b * c) * 4 <= 48 * 1024
