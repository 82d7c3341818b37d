"""Port parity: the DCT-dampen degradation and its inverse filter
(``elvis_tpu_torch.degrade.dct_dampen``, ``elvis_tpu_torch.restore.dampen``)
against ``elvis_tpu.degrade.dct_dampen`` and ``elvis_tpu.restore.dampen``,
on the same numpy inputs, on the CPU.

Tolerances: the level map exactly; float32 frames within 5e-4 grey levels;
uint8 frames within 1 LSB, a rounding tie at .5 falling the other way. The
block DCT is two float32 products a side in both packages, and the
inverse filter scales coefficients by up to 4x between them: their sums
run in another order, and the largest difference measured here is
2.14e-4 (b=8, the inverse filter), about 14 float32 ulps at 255.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.degrade.dct_dampen import dct_dampen as jdampen
from elvis_tpu.restore.dampen import restore_dct_dampen_inverse as jinverse
from elvis_tpu_torch.degrade.dct_dampen import dct_dampen as tdampen
from elvis_tpu_torch.restore.dampen import restore_dct_dampen_inverse as tinverse

F32_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(b, dtype, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (6, 64, 96, 3)).astype(dtype)
    scores = rng.random((6, 64 // b, 96 // b)).astype(np.float32)
    scores[0, 0, :3] = [0.05, 0.15, 0.25]  # rounding ties of scores * 10
    return frames, scores


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_dct_dampen_matches_jax(b, dtype):
    frames, scores = _inputs(b, dtype)
    j_out, j_lvl = jdampen(jnp.asarray(frames), jnp.asarray(scores), b)
    t_out, t_lvl = tdampen(torch.from_numpy(frames), torch.from_numpy(scores), b)
    np.testing.assert_array_equal(t_lvl.numpy(), np.asarray(j_lvl))
    assert t_lvl.dtype == torch.int32 and t_out.dtype == torch.from_numpy(frames).dtype
    a, w = t_out.numpy().astype(np.float64), np.asarray(j_out).astype(np.float64)
    np.testing.assert_allclose(a, w, rtol=0, atol=F32_ATOL if dtype == np.float32 else 1)
    assert np.abs(w - frames).max() > 10  # the dampening did something


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_inverse_filter_matches_jax(b, dtype):
    frames, scores = _inputs(b, dtype, seed=1)
    damp, lvl = jdampen(jnp.asarray(frames), jnp.asarray(scores), b)
    damp, lvl = np.array(damp), np.array(lvl)
    j_out = np.asarray(jinverse(jnp.asarray(damp), jnp.asarray(lvl), b))
    t_out = tinverse(torch.from_numpy(damp), torch.from_numpy(lvl), b).numpy()
    np.testing.assert_allclose(t_out.astype(np.float64), j_out.astype(np.float64), rtol=0,
                               atol=F32_ATOL if dtype == np.float32 else 1)
    # the inverse undoes the dampening where its gain is not capped
    err_in = np.abs(damp.astype(np.float64) - frames).mean()
    err_out = np.abs(t_out.astype(np.float64) - frames).mean()
    assert err_out < 0.5 * err_in


def test_inverse_is_registered():
    from elvis_tpu_torch.restore import get_restorer

    assert get_restorer("dct_dampen", "inverse_filter") is tinverse
