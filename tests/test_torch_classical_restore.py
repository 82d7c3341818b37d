"""Port parity: the classical restorers of the blur branch and the
benchmark rows (per-block Lanczos, unsharp mask, level-sequential, naive
SR, hybrid blend), elvis_tpu_torch against elvis_tpu on the same numpy
inputs, on the CPU.

Tolerances: float32 outputs ``atol=1e-3`` on 0-255 data (float32 sums in
different orders); uint8 outputs at most 1 LSB, on at most 0.1% of the
pixels (a value within float32 rounding of a .5 tie may round the other
way); level-0 blocks bit-exact where the restorer promises it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.degrade import adaptive as jadaptive
from elvis_tpu.restore import hybrid as jhybrid
from elvis_tpu.restore import lanczos as jlanczos
from elvis_tpu.restore import level_seq as jlevel
from elvis_tpu.restore import unsharp as junsharp
from elvis_tpu_torch.restore import hybrid as thybrid
from elvis_tpu_torch.restore import lanczos as tlanczos
from elvis_tpu_torch.restore import level_seq as tlevel
from elvis_tpu_torch.restore import unsharp as tunsharp
from elvis_tpu_torch.restore.registry import get_restorer

B = 8
ATOL = 1e-3
MAX_DIFF_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clip(tiny_video, dtype):
    if dtype == "uint8":
        return tiny_video
    return tiny_video.astype(np.float32) + 0.25


def _assert_close(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.dtype(dtype)
    if dtype == "uint8":
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= MAX_DIFF_SHARE
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


def _level0_blocks_equal(out, inp, maps):
    pix = np.repeat(np.repeat(np.asarray(maps) == 0, B, axis=-1), B, axis=-2)
    assert pix.any()
    np.testing.assert_array_equal(np.asarray(out)[pix], np.asarray(inp)[pix])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_restore_downsample_lanczos(rng, tiny_video, dtype):
    frames = _clip(tiny_video, dtype)
    levels = rng.integers(0, 4, (5, 6, 8)).astype(np.int32)
    want = jlanczos.restore_downsample_lanczos(jnp.asarray(frames), jnp.asarray(levels), B)
    got = tlanczos.restore_downsample_lanczos(torch.from_numpy(frames),
                                              torch.from_numpy(levels), B)
    _assert_close(got, want, dtype)
    _level0_blocks_equal(got.numpy(), frames, levels)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("max_scale", [4, 8])
def test_restore_downsample_scale_lanczos(rng, tiny_video, dtype, max_scale):
    frames = _clip(tiny_video, dtype)
    bins = rng.integers(0, max_scale, (5, 6, 8))
    scales = np.where(bins == 0, 0, bins + 1).astype(np.int32)
    want = jlanczos.restore_downsample_scale_lanczos(jnp.asarray(frames), jnp.asarray(scales),
                                                     B, max_scale)
    got = tlanczos.restore_downsample_scale_lanczos(torch.from_numpy(frames),
                                                    torch.from_numpy(scales), B, max_scale)
    _assert_close(got, want, dtype)
    _level0_blocks_equal(got.numpy(), frames, scales)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("max_rounds", [10, 4])
def test_restore_blur_unsharp(rng, tiny_video, dtype, max_rounds):
    scores = rng.random((5, 6, 8)).astype(np.float32)
    scores[:, 0, :] = 0.0  # a row of untouched blocks
    scores[:, 1, 0] = 1.0  # and the strongest level
    blurred, rounds = jadaptive.adaptive_blur(jnp.asarray(_clip(tiny_video, dtype)),
                                              jnp.asarray(scores), B, max_rounds)
    blurred, rounds = np.array(blurred), np.array(rounds)  # writable copies
    assert rounds.max() == max_rounds and rounds.min() == 0
    want = junsharp.restore_blur_unsharp(jnp.asarray(blurred), jnp.asarray(rounds), B, max_rounds)
    got = tunsharp.restore_blur_unsharp(torch.from_numpy(blurred), torch.from_numpy(rounds),
                                        B, max_rounds)
    _assert_close(got, want, dtype)
    _level0_blocks_equal(got.numpy(), blurred, rounds)
    assert np.abs(got.numpy().astype(np.float32) - blurred).max() > 1  # it sharpened


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_level_sequential_restore(rng, tiny_video, dtype):
    frames = _clip(tiny_video, dtype)
    levels = rng.integers(0, 4, (5, 6, 8)).astype(np.int32)

    def j_fn(f, lvl):
        return f.astype(jnp.float32) * (1.0 - 0.1 * lvl) + 3.3 * lvl

    def t_fn(f, lvl):
        return f.float() * (1.0 - 0.1 * lvl) + 3.3 * lvl

    want = jlevel.level_sequential_restore(j_fn, jnp.asarray(frames), jnp.asarray(levels), B, 3)
    got = tlevel.level_sequential_restore(t_fn, torch.from_numpy(frames),
                                          torch.from_numpy(levels), B, 3)
    _assert_close(got, want, dtype)
    _level0_blocks_equal(got.numpy(), frames, levels)
    # a level above max_level is never restored: the block passes through
    got2 = tlevel.level_sequential_restore(t_fn, torch.from_numpy(frames),
                                           torch.from_numpy(levels), B, 2)
    want2 = jlevel.level_sequential_restore(j_fn, jnp.asarray(frames), jnp.asarray(levels), B, 2)
    _assert_close(got2, want2, dtype)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("custom_up", [False, True])
def test_naive_sr_restore(rng, tiny_video, dtype, custom_up):
    from elvis_tpu.ops.resize import resize as jresize
    from elvis_tpu_torch.ops.resize import resize as tresize

    frames = _clip(tiny_video, dtype)
    levels = np.zeros((5, 6, 8), np.int32)  # ignored: the restorer is map-blind
    j_up = (lambda f: jresize(f, (96, 128), method="linear") + 2.0) if custom_up else None
    t_up = (lambda f: tresize(f, (96, 128), method="linear") + 2.0) if custom_up else None
    want = jlevel.naive_sr_restore(jnp.asarray(frames), jnp.asarray(levels), B, upsample_fn=j_up)
    got = tlevel.naive_sr_restore(torch.from_numpy(frames), torch.from_numpy(levels), B,
                                  upsample_fn=t_up)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("alpha,max_level", [(0.1, None), (0.5, 3), (0.0, None)])
def test_blended_restoration(rng, tiny_video, dtype, alpha, max_level):
    classical = _clip(tiny_video, dtype)
    neural = np.clip(classical.astype(np.float32) + rng.normal(0, 9, classical.shape),
                     0, 255).astype(classical.dtype)
    levels = rng.integers(0, 3, (5, 6, 8)).astype(np.int32)
    want = jhybrid.blended_restoration(jnp.asarray(classical), jnp.asarray(neural),
                                       jnp.asarray(levels), B, alpha, max_level)
    got = thybrid.blended_restoration(torch.from_numpy(classical), torch.from_numpy(neural),
                                      torch.from_numpy(levels), B, alpha, max_level)
    _assert_close(got, want, dtype)
    _level0_blocks_equal(got.numpy(), classical, levels)


def test_blended_restoration_all_zero_map(tiny_video):
    """max_level falls back to 1 on an all-zero map: no division by zero."""
    z = torch.zeros((5, 6, 8), dtype=torch.int32)
    x = torch.from_numpy(tiny_video)
    assert torch.equal(thybrid.blended_restoration(x, 255 - x, z, B), x)


@pytest.mark.parametrize("key,fn", [
    (("downsample", "lanczos"), tlanczos.restore_downsample_lanczos),
    (("downsample_scale", "lanczos"), tlanczos.restore_downsample_scale_lanczos),
    (("blur", "unsharp"), tunsharp.restore_blur_unsharp),
    (("downsample", "naive_sr"), tlevel.naive_sr_restore),
])
def test_registered_like_the_jax_package(key, fn):
    from elvis_tpu.restore.registry import get_restorer as jget

    assert get_restorer(*key) is fn
    assert jget(*key).__name__ == fn.__name__
