"""Port parity: the rest of ``ops.filter`` (``iterated_gaussian_blur_levels``,
``unsharp_mask``, ``sobel_energy``) and the edge pad of ``ops.resize``.

The same numpy inputs go through the JAX function and the port's on the
CPU. Tolerances: uint8 within 1 LSB (a value within float32 rounding of
a .5 tie may round apart), float32 within 1e-5 of the 0-255 data (both
sum the same taps in float32, in the same order), the Sobel energy within
1e-4 relative.

The edge pad: the port's ``_edge_pad`` concatenates the edge slices where
it used to gather clamped indices (``index_select``, whose backward on a
card adds the repeated rows with atomics). Its forward and its CPU
gradient are held bit-equal to the gather's, alone and through
``upsample2x_phases``.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.ops import filter as jfilter
from elvis_tpu_torch import ops as tops
from elvis_tpu_torch.ops import filter as tfilter

tresize = importlib.import_module("elvis_tpu_torch.ops.resize")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _images(rng, dtype, shape=(2, 12, 10, 3)):
    return (rng.random(shape) * 255).astype(dtype)


def _held(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1 if dtype == np.uint8 else 1e-5
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_iterated_gaussian_blur_levels(rng, dtype):
    x = _images(rng, dtype)
    want = jfilter.iterated_gaussian_blur_levels(jnp.asarray(x), 4)
    got = tfilter.iterated_gaussian_blur_levels(torch.from_numpy(x), 4)
    assert got.shape == (5, *x.shape)
    _held(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("per_block", [False, True])
def test_unsharp_mask(rng, dtype, per_block):
    """A scalar amount on frames, or one amount per block of a
    ``(M, b, b, C)`` block tensor filtered within each block."""
    if per_block:
        x = _images(rng, dtype, (6, 8, 8, 3))
        amount = rng.random((6, 1, 1, 1)).astype(np.float32) * 1.5
        axes = dict(h_axis=-3, w_axis=-2)
        want = jfilter.unsharp_mask(jnp.asarray(x), jnp.asarray(amount), radius=2, **axes)
        got = tops.unsharp_mask(torch.from_numpy(x), torch.from_numpy(amount), radius=2, **axes)
    else:
        x = _images(rng, dtype)
        want = jfilter.unsharp_mask(jnp.asarray(x), 0.7)
        got = tops.unsharp_mask(torch.from_numpy(x), 0.7)
    _held(got.numpy(), want, dtype)


def test_sobel_energy(rng):
    gray = (rng.random((3, 14, 11)) * 255).astype(np.float32)
    want = np.asarray(jfilter.sobel_energy(jnp.asarray(gray)))
    got = tops.sobel_energy(torch.from_numpy(gray)).numpy()
    assert got.dtype == np.float32 and got.shape == gray.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _gather_pad(x, axis):
    """The edge pad as it was: a gather of clamped indices."""
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-tresize._UP2X_PAD, n + tresize._UP2X_PAD), 0, n - 1)
    return torch.index_select(x, axis, idx)


@pytest.mark.parametrize("shape,axis", [((2, 7, 9, 3), 1), ((2, 7, 9, 3), 2),
                                        ((3, 5, 6, 2, 3), 2), ((2, 1, 5, 3), 1)])
def test_edge_pad_equals_the_gather_forward_and_backward(rng, shape, axis):
    x = torch.from_numpy(_images(rng, np.float32, shape))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want, got = _gather_pad(a, axis), tresize._edge_pad(b, axis)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.standard_normal(tuple(want.shape)).astype(np.float32) * 100)
    (want * g).sum().backward()
    (got * g).sum().backward()
    assert torch.equal(b.grad, a.grad)


@pytest.mark.parametrize("method", ["lanczos4", "linear"])
def test_upsample2x_phases_forward_and_gradient_unchanged(rng, monkeypatch, method):
    x = torch.from_numpy(_images(rng, np.float32, (2, 6, 10, 3)))
    g = torch.from_numpy(rng.standard_normal((2, 6, 10, 2, 2, 3)).astype(np.float32))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = tresize.upsample2x_phases(b, method)
    (got * g).sum().backward()
    monkeypatch.setattr(tresize, "_edge_pad", _gather_pad)
    want = tresize.upsample2x_phases(a, method)
    (want * g).sum().backward()
    assert torch.equal(got, want) and torch.equal(b.grad, a.grad)
