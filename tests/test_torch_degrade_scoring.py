"""Port parity: adaptive degradation and removability scoring
(elvis_tpu_torch against elvis_tpu on the same numpy inputs, on the CPU).

Tolerances:
  * level maps are integers and must be equal;
  * degraded uint8 frames may differ by 1 LSB where a float32 value lands
    next to a .5 rounding tie (the two sides sum in different orders);
    float32 frames are held to ``atol=1e-3`` on 0-255 data, the kernel
    tolerance;
  * scores, saliency and the fused maps live in [0, 1] and are held to
    ``atol=1e-5``; SC/TC are DCT energies of 0-255 luma (values up to a few
    hundred), held to ``rtol=1e-5`` with the same ``atol``;
  * a level map made from each side's OWN scores may differ only at blocks
    whose ``score * log2(b)`` lies within 1e-5 of a rounding boundary.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

jadaptive, jcomplexity, jfusion, jsaliency = (
    importlib.import_module(f"elvis_tpu.{m}")
    for m in ("degrade.adaptive", "scoring.complexity", "scoring.fusion", "scoring.saliency"))
tadaptive, tcomplexity, tfusion, tsaliency = (
    importlib.import_module(f"elvis_tpu_torch.{m}")
    for m in ("degrade.adaptive", "scoring.complexity", "scoring.fusion", "scoring.saliency"))

ATOL_SCORE = 1e-5
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scores(rng, video):
    n, h, w, _ = video.shape
    s = rng.random((n, h // B, w // B)).astype(np.float32)
    s[0, 0, :4] = [0.0, 1.0, 1 / 6, 0.5]  # exact ties of score * log2(8) = k + 1/2
    return s


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("op", ["downsample", "blur", "scale"])
def test_adaptive_ops(rng, tiny_video, dtype, op):
    frames = tiny_video.astype(dtype)
    scores = _scores(rng, frames)
    jfn, tfn = {
        "downsample": (jadaptive.adaptive_downsample, tadaptive.adaptive_downsample),
        "blur": (jadaptive.adaptive_blur, tadaptive.adaptive_blur),
        "scale": (jadaptive.adaptive_downsample_scale, tadaptive.adaptive_downsample_scale),
    }[op]
    jout, jmap = jfn(jnp.asarray(frames), jnp.asarray(scores), B)
    tout, tmap = tfn(torch.from_numpy(frames), torch.from_numpy(scores), B)
    np.testing.assert_array_equal(_np(tmap), _np(jmap))
    assert _np(tmap).dtype == np.int32
    got, want = _np(tout), _np(jout)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        assert np.mean(diff > 0) < 0.01
    else:
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_levels_round_half_to_even():
    s = np.array([0.0, 1 / 6, 0.5, 5 / 6, 1.0], np.float32)  # * 3 -> 0, .5, 1.5, 2.5, 3
    want = _np(jadaptive.downsample_levels_from_scores(jnp.asarray(s), B))
    got = _np(tadaptive.downsample_levels_from_scores(torch.from_numpy(s), B))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(tadaptive.blur_levels_from_scores(torch.from_numpy(s))),
        _np(jadaptive.blur_levels_from_scores(jnp.asarray(s))))


@pytest.mark.parametrize("name", ["motion_contrast", "center_prior"])
def test_saliency(tiny_video, name):
    want = _np(jsaliency.get_saliency_fn(name)(jnp.asarray(tiny_video)))
    got = _np(tsaliency.get_saliency_fn(name)(torch.from_numpy(tiny_video)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL_SCORE)
    np.testing.assert_array_equal(
        _np(tsaliency.saliency_to_block_mask(torch.from_numpy(want.copy()), B)),
        _np(jsaliency.saliency_to_block_mask(jnp.asarray(want), B)))


def test_complexity(tiny_video):
    j = jcomplexity.spatial_temporal_complexity(jnp.asarray(tiny_video), B)
    t = tcomplexity.spatial_temporal_complexity(torch.from_numpy(tiny_video), B)
    for a, b in ((t.SC, j.SC), (t.TC, j.TC)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=ATOL_SCORE)
    assert float(_np(t.TC)[0].max()) == 0.0


def test_fusion(rng):
    sc = (rng.random((4, 6, 8)) * 50).astype(np.float32)
    tc = (rng.random((4, 6, 8)) * 30).astype(np.float32)
    fg = rng.random((4, 6, 8)) > 0.6
    w = rng.random((4, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tfusion.removability_scores(torch.from_numpy(sc), torch.from_numpy(tc),
                                        torch.from_numpy(fg))),
        _np(jfusion.removability_scores(jnp.asarray(sc), jnp.asarray(tc), jnp.asarray(fg))),
        atol=ATOL_SCORE)
    np.testing.assert_allclose(
        _np(tfusion.importance_scores(torch.from_numpy(sc), torch.from_numpy(tc),
                                      torch.from_numpy(w))),
        _np(jfusion.importance_scores(jnp.asarray(sc), jnp.asarray(tc), jnp.asarray(w))),
        atol=ATOL_SCORE)
    np.testing.assert_allclose(_np(tfusion.normalize01(torch.from_numpy(sc), axis=(1, 2))),
                               _np(jfusion.normalize01(jnp.asarray(sc), axis=(1, 2))),
                               atol=ATOL_SCORE)


def _removability(video, side):
    """Stage 1 of the main path on one side: complexity + motion-contrast
    saliency -> removability scores."""
    if side == "jax":
        x = jnp.asarray(video)
        cx = jcomplexity.spatial_temporal_complexity(x, B)
        sal = jsaliency.motion_contrast_saliency(x)
        return _np(jfusion.removability_scores(cx.SC, cx.TC,
                                               jsaliency.saliency_to_block_mask(sal, B)))
    x = torch.from_numpy(video)
    cx = tcomplexity.spatial_temporal_complexity(x, B)
    sal = tsaliency.motion_contrast_saliency(x)
    return _np(tfusion.removability_scores(cx.SC, cx.TC,
                                           tsaliency.saliency_to_block_mask(sal, B)))


def test_scores_and_levels_from_own_scores(tiny_video):
    js, ts = _removability(tiny_video, "jax"), _removability(tiny_video, "torch")
    np.testing.assert_allclose(ts, js, atol=ATOL_SCORE)
    jl = _np(jadaptive.downsample_levels_from_scores(jnp.asarray(js), B))
    tl = _np(tadaptive.downsample_levels_from_scores(torch.from_numpy(ts), B))
    scaled = js.astype(np.float64) * np.log2(B)
    near_tie = np.abs(scaled - (np.floor(scaled) + 0.5)) < 1e-5
    assert np.all((jl == tl) | near_tie)
