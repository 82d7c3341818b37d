"""Port parity: block algebra, filters, resize, colour and DCT
(elvis_tpu_torch against elvis_tpu on the same numpy inputs, on the CPU).

Tolerances: block algebra is pure data movement, so exact equality; the
resize/DCT/filter arithmetic runs in float32 on both sides with possibly
different summation order, so ``atol=1e-4`` on 0-255 data (float32 carries
~1.5e-5 absolute at 255). Integer outputs round those values and must be
equal.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

# import_module: the ops packages re-export a function named `resize`
jblocks, jcolor, jdct, jfilter, jresize = (
    importlib.import_module(f"elvis_tpu.{m}")
    for m in ("core.blocks", "ops.color", "ops.dct", "ops.filter", "ops.resize"))
tblocks, tcolor, tdct, tfilter, tresize = (
    importlib.import_module(f"elvis_tpu_torch.{m}")
    for m in ("core.blocks", "ops.color", "ops.dct", "ops.filter", "ops.resize"))

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_split_combine_upsample_reduce_exact(rng):
    x = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    jx, tx = _pair(x)
    assert tblocks.block_grid_shape(16, 24, 8) == jblocks.block_grid_shape(16, 24, 8)
    jb, tb = jblocks.split_into_blocks(jx, 8), tblocks.split_into_blocks(tx, 8)
    np.testing.assert_array_equal(_np(tb), _np(jb))
    np.testing.assert_array_equal(_np(tblocks.combine_blocks(tb)), x)
    m = rng.integers(0, 4, (2, 2, 3)).astype(np.int32)
    jm, tm = _pair(m)
    np.testing.assert_array_equal(_np(tblocks.upsample_map(tm, 8)),
                                  _np(jblocks.upsample_map(jm, 8)))
    g = rng.random((2, 16, 24)).astype(np.float32)
    jg, tg = _pair(g)
    np.testing.assert_array_equal(
        _np(tblocks.blockwise_reduce(tg, 8, torch.amax)),
        _np(jblocks.blockwise_reduce(jg, 8, jnp.max)))
    np.testing.assert_allclose(
        _np(tblocks.blockwise_reduce(tx.float(), 8, torch.mean, with_channels=True)),
        _np(jblocks.blockwise_reduce(jx.astype(jnp.float32), 8, jnp.mean,
                                     with_channels=True)), atol=ATOL)
    with pytest.raises(ValueError):
        tblocks.block_grid_shape(17, 24, 8)


@pytest.mark.parametrize("n,pad", [(8, 2), (3, 5), (1, 2), (16, 7)])
def test_reflect101_indices_and_kernel_exact(n, pad):
    np.testing.assert_array_equal(tfilter._reflect101_indices(n, pad),
                                  jfilter._reflect101_indices(n, pad))
    np.testing.assert_array_equal(tfilter.gaussian_kernel_1d(5, 2.0),
                                  jfilter.gaussian_kernel_1d(5, 2.0))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gaussian_blur(rng, dtype):
    x = (rng.random((2, 12, 10, 3)) * 255).astype(dtype)
    jx, tx = _pair(x)
    got = _np(tfilter.gaussian_blur(tx, 5, 1.0))
    want = _np(jfilter.gaussian_blur(jx, 5, 1.0))
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=ATOL if dtype == np.float32 else 0)


@pytest.mark.parametrize("method", ["area", "linear", "lanczos4", "nearest"])
@pytest.mark.parametrize("dst,src", [(4, 16), (16, 4), (7, 12), (12, 7), (9, 9)])
def test_resize_matrix_exact(method, dst, src):
    np.testing.assert_array_equal(tresize.resize_matrix(dst, src, method),
                                  jresize.resize_matrix(dst, src, method))


@pytest.mark.parametrize("out_hw,method", [
    ((32, 48), "lanczos4"),   # exact 2x: shifted-tap fast path
    ((32, 48), "linear"),
    ((4, 6), "area"),         # integer area: reshape-mean fast path
    ((10, 14), "area"),       # dense matrices
    ((23, 31), "lanczos4"),
    ((9, 5), "nearest"),
    ((16, 24), "linear"),     # identity
])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize(rng, out_hw, method, dtype):
    x = (rng.random((2, 16, 24, 3)) * 255).astype(dtype)
    jx, tx = _pair(x)
    got = _np(tresize.resize(tx, out_hw, method))
    want = _np(jresize.resize(jx, out_hw, method))
    assert got.dtype == want.dtype and got.shape == want.shape
    # uint8 outputs round float32 values that may differ in the last bit;
    # where one lands on a .5 tie the two sides can round 1 LSB apart
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=ATOL if dtype == np.float32 else 1)
    if dtype == np.uint8:
        assert np.mean(got != want) < 0.01


def test_resize_channelless_map(rng):
    x = rng.random((2, 6, 3)).astype(np.float32)  # trailing 3 is blocks, not channels
    jx, tx = _pair(x)
    np.testing.assert_allclose(
        _np(tresize.resize(tx, (12, 6), "nearest", channels=False)),
        _np(jresize.resize(jx, (12, 6), "nearest", channels=False)), atol=ATOL)


@pytest.mark.parametrize("method", ["lanczos4", "linear"])
def test_upsample2x_phases_and_interleave(rng, method):
    x = (rng.random((2, 6, 5, 3)) * 255).astype(np.float32)
    jx, tx = _pair(x)
    tph = tresize.upsample2x_phases(tx, method)
    jph = jresize.upsample2x_phases(jx, method)
    np.testing.assert_allclose(_np(tph), _np(jph), atol=ATOL)
    np.testing.assert_array_equal(_np(tresize.interleave_phases(tph)),
                                  _np(jresize.interleave_phases(jnp.asarray(_np(tph)))))
    full = tresize.interleave_phases(tph)
    np.testing.assert_array_equal(_np(tresize.deinterleave_phases(full)), _np(tph))
    np.testing.assert_allclose(_np(full), _np(jresize.resize(jx, (12, 10), method)),
                               atol=ATOL)


def test_color(rng):
    for dtype in (np.float32, np.uint8):
        x = (rng.random((2, 5, 7, 3)) * 255).astype(dtype)
        jx, tx = _pair(x)
        for tf, jf in ((tcolor.rgb_to_gray, jcolor.rgb_to_gray),
                       (tcolor.rgb_to_ycbcr, jcolor.rgb_to_ycbcr)):
            got, want = _np(tf(tx)), _np(jf(jx))
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                       atol=ATOL if dtype == np.float32 else 0)


@pytest.mark.parametrize("b", [8, 16])
def test_dct(rng, b):
    np.testing.assert_array_equal(tdct.dct_matrix(b), jdct.dct_matrix(b))
    x = (rng.random((3, 2, b, b)) * 255).astype(np.float32)
    jx, tx = _pair(x)
    # the orthonormal 2-D DCT scales 0-255 data by up to b, so 1e-4 on the
    # 0-255 scale is 1e-4 * b on the coefficients
    np.testing.assert_allclose(_np(tdct.block_dct2(tx)), _np(jdct.block_dct2(jx)),
                               atol=ATOL * b)
