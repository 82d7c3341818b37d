"""Port parity: masked pixel metrics (elvis_tpu_torch against elvis_tpu on
the same numpy inputs, on the CPU).

Tolerances: MSE and PSNR reduce float32 squares in different orders, so
``rtol=1e-5`` on MSE and ``atol=1e-4`` dB on PSNR; SSIM is in [-1, 1] and
held to ``atol=1e-5``; the bbox is integer geometry and must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.metrics import pixel as jpixel
from elvis_tpu_torch.metrics import pixel as tpixel


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(rng):
    ref = (rng.random((3, 24, 32, 3)) * 255).astype(np.uint8)
    noise = rng.normal(0, 8, ref.shape)
    dec = np.clip(ref + noise, 0, 255).astype(np.uint8)
    dec[2] = ref[2]  # identical frame: PSNR caps at 100
    mask = np.zeros((3, 24, 32), bool)
    mask[0, 4:15, 6:20] = True
    mask[1, 10:12, 3:4] = True  # tiny crop
    return ref, dec, mask


@pytest.mark.parametrize("masked", [False, True])
def test_mse_psnr(rng, masked):
    ref, dec, mask = _inputs(rng)
    m_t = torch.from_numpy(mask) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    args_t = (torch.from_numpy(ref), torch.from_numpy(dec), m_t)
    args_j = (jnp.asarray(ref), jnp.asarray(dec), m_j)
    np.testing.assert_allclose(_np(tpixel.masked_mse(*args_t)), _np(jpixel.masked_mse(*args_j)),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tpixel.masked_psnr(*args_t)),
                               _np(jpixel.masked_psnr(*args_j)), atol=1e-4)


def test_ssim_and_masked_ssim(rng):
    ref, dec, mask = _inputs(rng)
    yr, yd = ref[..., 0].astype(np.float32), dec[..., 1].astype(np.float32)
    np.testing.assert_allclose(_np(tpixel.ssim(torch.from_numpy(yr), torch.from_numpy(yd))),
                               _np(jpixel.ssim(jnp.asarray(yr), jnp.asarray(yd))), atol=1e-5)
    for m in (None, mask, mask[:, ::-1, :].copy()):
        got = tpixel.masked_ssim(torch.from_numpy(ref), torch.from_numpy(dec),
                                 None if m is None else torch.from_numpy(m))
        want = jpixel.masked_ssim(jnp.asarray(ref), jnp.asarray(dec),
                                  None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_mask_union_bbox(rng):
    _, _, mask = _inputs(rng)
    for m in (mask, np.zeros_like(mask), mask[0]):
        assert tpixel.mask_union_bbox(torch.from_numpy(m)) == jpixel.mask_union_bbox(m)
