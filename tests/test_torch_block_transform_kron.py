"""Port parity: ``apply_block_matrix_kron``, the dense route of the block
transform (one product against every level's ``T_l (x) T_l``, then a
gather of each block's level).

Held to the JAX package's ``apply_block_matrix_kron`` and to the port's
plain ``apply_block_matrix`` at b=8 and b=16, with levels that include
-1, -L-1, L and L+5 (a negative level wraps once, the rest is clamped),
within 1e-4 of the largest value: both compute in float32 and differ
only in summation order (b^2 terms where the plain version sums 2b).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.kernels import block_transform as jbt
from elvis_tpu_torch import kernels as tkernels
from elvis_tpu_torch.kernels import block_transform as tbt

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_kron_stack_exact():
    table = jbt.blur_matrix_table(8, 10)
    np.testing.assert_array_equal(tbt._kron_of(np.asarray(table)), jbt._kron_of(table))


@pytest.mark.parametrize("b,table", [(8, jbt.resample_matrix_table(8, "linear")),
                                     (16, jbt.blur_matrix_table(16, 10))])
def test_kron_route_matches_jax_and_the_plain_version(rng, b, table):
    ell = table.shape[0]
    blocks = (rng.random((2, 3, 5, b, b, 3)) * 255).astype(np.float32)
    idx = rng.integers(0, ell, (2, 3, 5)).astype(np.int32)
    idx.flat[:4] = [-1, -ell - 1, ell, ell + 5]
    want = np.asarray(jbt.apply_block_matrix_kron(jnp.asarray(blocks), jnp.asarray(table),
                                                  jnp.asarray(idx)))
    got = tkernels.apply_block_matrix_kron(torch.from_numpy(blocks), table,
                                           torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == blocks.shape
    plain = tbt.apply_block_matrix(torch.from_numpy(blocks),
                                   torch.as_tensor(table, dtype=torch.float32),
                                   torch.from_numpy(idx)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= REL * scale
    assert np.abs(got.numpy() - plain).max() <= REL * scale
