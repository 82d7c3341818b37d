"""Port parity: the removal degradation (``degrade.removal``) and block
motion (``ops.motion``) against ``elvis_tpu``, as the pipeline runs them
(JAX side under ``jax.jit``, as ``run_elvis`` calls them).

Tolerances: the removal mask, the shrunk and the stretched frames are
EXACT, with every cooldown and with tied scores (a stable ascending sort
of the negated scores on both sides). Block motion is EXACT on these
inputs (integer vectors; ``argmin`` keeps the first minimum over the
zero-motion-first candidates on both sides); winning SADs and sub-pel
fields agree to 1e-4 absolute (float32 sums in another order). The motion
hint (quarter-pel ints) is EXACT, including medians over an even count of
blocks, where ``jnp.median`` averages the two middle values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.degrade import removal as jrem
from elvis_tpu.ops import motion as jmot
from elvis_tpu_torch.degrade import removal as trem
from elvis_tpu_torch.ops import motion as tmot

SAD_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scores(kind, n=6, by=4, bx=10, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random((n, by, bx)).astype(np.float32)
    if kind == "constant":
        return np.full((n, by, bx), 0.5, np.float32)
    return (rng.integers(0, 3, (n, by, bx)) / 2.0).astype(np.float32)  # many ties


@pytest.mark.parametrize("kind", ["random", "constant", "ties"])
@pytest.mark.parametrize("cooldown", [0, 1, 2])
@pytest.mark.parametrize("amount", [0.25, 0.5, 3])
def test_removal_mask_shrink_stretch_exact(kind, cooldown, amount):
    b = 8
    scores = _scores(kind)
    n, by, bx = scores.shape
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (n, by * b, bx * b, 3)).astype(np.uint8)
    k = trem.removal_blocks_per_row(bx, amount)
    assert k == jrem.removal_blocks_per_row(bx, amount)
    jm = np.asarray(jax.jit(lambda s: jrem.removal_mask_from_scores(s, bx, amount, cooldown))(
        jnp.asarray(scores)))
    tm = trem.removal_mask_from_scores(torch.from_numpy(scores), bx, amount, cooldown)
    assert tm.dtype == torch.int8 and np.array_equal(_np(tm), jm)
    assert (jm.sum(-1) == k).all()
    js = np.asarray(jrem.apply_removal_mask(jnp.asarray(frames), jnp.asarray(jm), b, k))
    ts = trem.apply_removal_mask(torch.from_numpy(frames), tm, b, k)
    assert np.array_equal(_np(ts), js) and js.shape[2] == (bx - k) * b
    assert np.array_equal(_np(trem.apply_removal_mask(torch.from_numpy(frames), tm, b)), js)
    jst = np.asarray(jrem.stretch_frames(jnp.asarray(js), jnp.asarray(jm), b))
    tst = trem.stretch_frames(ts, tm, b)
    assert np.array_equal(_np(tst), jst)
    ja, jmask = jrem.apply_selective_removal(jnp.asarray(frames), jnp.asarray(scores), b,
                                             amount, cooldown)
    ta, tmask = trem.apply_selective_removal(torch.from_numpy(frames), torch.from_numpy(scores),
                                             b, amount, cooldown)
    assert np.array_equal(_np(ta), np.asarray(ja)) and np.array_equal(_np(tmask), np.asarray(jmask))


def test_no_removal_when_k_is_zero():
    scores = torch.from_numpy(_scores("random", bx=3))
    assert int(trem.removal_mask_from_scores(scores, 3, 0.25).sum()) == 0
    f = torch.zeros((6, 32, 24, 3), dtype=torch.uint8)
    assert trem.apply_removal_mask(f, torch.zeros((6, 4, 3), dtype=torch.int8), 8) is f


def _panning_clip(n=5, h=64, w=96, step=(1, 2), seed=0, rgb=False):
    """A smooth random texture translated by ``step`` px a frame, + noise."""
    rng = np.random.default_rng(seed)
    pad = 4 * n
    tex = rng.random((h + 2 * pad, w + 2 * pad)).astype(np.float32)
    tex = np.cumsum(np.cumsum(tex, 0), 1)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 200 + 20
    tex += 30 * np.sin(np.arange(w + 2 * pad)[None] / 3.0) * np.cos(
        np.arange(h + 2 * pad)[:, None] / 4.0)
    frames = []
    for t in range(n):
        y0, x0 = pad - t * step[0], pad - t * step[1]
        frames.append(tex[y0:y0 + h, x0:x0 + w] + rng.normal(0, 1.0, (h, w)))
    out = np.clip(np.stack(frames), 0, 255).astype(np.float32)
    if rgb:
        out = np.clip(np.stack([out, out * 0.9, out * 1.05], -1), 0, 255).astype(np.uint8)
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["pan", "flat"])
def test_block_motion_exact(weighted, case):
    clip = _panning_clip() if case == "pan" else np.full((3, 48, 64), 90.0, np.float32)
    prev, cur = clip[:-1], clip[1:]
    kw_j, kw_t = {}, {}
    if weighted:
        rng = np.random.default_rng(2)
        wt = (rng.random(prev.shape) > 0.3).astype(np.float32)
        kw_j = dict(prev_weight=jnp.asarray(wt), cur_weight=jnp.asarray(wt[::-1].copy()))
        kw_t = dict(prev_weight=torch.from_numpy(wt), cur_weight=torch.from_numpy(wt[::-1].copy()))
    jmv, jsad = jax.jit(lambda p, c: jmot.block_motion(p, c, 16, 4, return_sad=True, **kw_j))(
        jnp.asarray(prev), jnp.asarray(cur))
    tmv, tsad = tmot.block_motion(torch.from_numpy(prev), torch.from_numpy(cur), 16, 4,
                                  return_sad=True, **kw_t)
    assert tmv.dtype == torch.int32 and np.array_equal(_np(tmv), np.asarray(jmv))
    np.testing.assert_allclose(_np(tsad), np.asarray(jsad), atol=SAD_ATOL, rtol=1e-5)
    if case == "flat":  # every offset ties: zero motion
        assert not _np(tmv).any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("levels,bsz,shape", [(3, 16, (64, 96)), (4, 16, (80, 112)),
                                               (2, 8, (40, 56))])
def test_block_motion_pyramid_exact(weighted, levels, bsz, shape):
    clip = _panning_clip(n=4, h=shape[0], w=shape[1], step=(3, -5))
    prev, cur = clip[:-1], clip[1:]
    kw_j, kw_t = {}, {}
    if weighted:
        wt = np.ones_like(prev)
        wt[:, 8:24, 16:40] = 0.0  # a hole
        kw_j, kw_t = dict(prev_weight=jnp.asarray(wt)), dict(prev_weight=torch.from_numpy(wt))
    jmv, jsad = jax.jit(lambda p, c: jmot.block_motion_pyramid(
        p, c, bsz, 4, levels=levels, return_sad=True, **kw_j))(jnp.asarray(prev), jnp.asarray(cur))
    tmv, tsad = tmot.block_motion_pyramid(torch.from_numpy(prev), torch.from_numpy(cur), bsz, 4,
                                          levels=levels, return_sad=True, **kw_t)
    assert np.array_equal(_np(tmv), np.asarray(jmv))
    np.testing.assert_allclose(_np(tsad), np.asarray(jsad), atol=SAD_ATOL, rtol=1e-5)
    assert np.array_equal(_np(tmot.block_motion_pyramid(torch.from_numpy(prev),
                                                         torch.from_numpy(cur), bsz, 4,
                                                         levels=levels, **kw_t)),
                          np.asarray(jmv))
    assert tmot.pyramid_range(4, levels) == jmot.pyramid_range(4, levels)


def test_median3_subpel_field_sad():
    rng = np.random.default_rng(4)
    field = rng.integers(-3, 4, (2, 5, 7, 2)).astype(np.int32)
    assert np.array_equal(_np(tmot.median3_field(torch.from_numpy(field))),
                          np.asarray(jmot.median3_field(jnp.asarray(field))))
    clip = _panning_clip(n=3, h=48, w=64, step=(1, 1))
    prev, cur = clip[:-1], clip[1:]
    f = rng.integers(-2, 3, (2, 3, 4, 2)).astype(np.int32)
    jsad = jax.jit(lambda p, c, f_: jmot.field_sad(p, c, f_, 16))(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(f))
    tsad = tmot.field_sad(torch.from_numpy(prev), torch.from_numpy(cur), torch.from_numpy(f), 16)
    np.testing.assert_allclose(_np(tsad), np.asarray(jsad), atol=SAD_ATOL, rtol=1e-5)
    jsub = jax.jit(lambda p, c, f_: jmot.subpel_refine(p, c, f_, 16))(
        jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(f))
    tsub = tmot.subpel_refine(torch.from_numpy(prev), torch.from_numpy(cur),
                              torch.from_numpy(f), 16)
    np.testing.assert_allclose(_np(tsub), np.asarray(jsub), atol=1e-4)


def test_even_count_medians_average_the_two_middles():
    x = np.array([[[1.0, 9.0], [4.0, 2.0]], [[5.0, 5.0], [0.0, 8.0]]], np.float32)
    t = tmot._median(torch.from_numpy(x), (1, 2), keepdim=True)
    assert np.array_equal(_np(t), np.asarray(jnp.median(jnp.asarray(x), axis=(1, 2),
                                                        keepdims=True)))
    assert _np(t).ravel().tolist() == [3.0, 5.0]  # not torch.median's 2.0 and 5.0
    y = np.array([[[1.0, np.nan], [7.0, 4.0]], [[np.nan, np.nan], [np.nan, np.nan]],
                  [[3.0, 6.0], [np.nan, 2.0]]], np.float32)[..., None].repeat(2, -1)
    y[..., 1] = np.where(np.isnan(y[..., 1]), np.nan, y[..., 1] * 2)
    y[0, 0, 0, 1] = 9.0  # four values, the two middles differ
    jn = np.asarray(jnp.nanmedian(jnp.asarray(y), axis=(1, 2)))
    tn = _np(tmot._nanmedian(torch.from_numpy(y), (1, 2)))
    assert np.array_equal(np.isnan(tn), np.isnan(jn))
    assert np.array_equal(tn[~np.isnan(tn)], jn[~np.isnan(jn)])


@pytest.mark.parametrize("coarse,step,hw", [(1, (1, 2), (64, 96)), (2, (-2, 3), (64, 96)),
                                            (1, (0, 0), (48, 80)), (3, (2, -1), (56, 72))])
def test_motion_hint_gmv_and_dev_equal(coarse, step, hw):
    clip = _panning_clip(n=5, h=hw[0], w=hw[1], step=step, seed=3, rgb=True)
    jg, jd = jax.jit(lambda f: jmot.motion_hint(f, 8, coarse=coarse))(jnp.asarray(clip))
    tg, td = tmot.motion_hint(torch.from_numpy(clip), 8, coarse=coarse)
    assert tg.dtype == torch.int16 and td.dtype == torch.int8
    assert np.array_equal(_np(tg), np.asarray(jg))
    assert np.array_equal(_np(td), np.asarray(jd))
    if step != (0, 0):
        assert _np(tg).any()
    by, bx = hw[0] // 8, hw[1] // 8
    jf = jmot.motion_field_from_hint(jg, jd, by, bx, coarse=coarse)
    tf = tmot.motion_field_from_hint(tg, td, by, bx, coarse=coarse)
    assert tf.shape == (5, by, bx, 2) and np.array_equal(_np(tf), np.asarray(jf))
