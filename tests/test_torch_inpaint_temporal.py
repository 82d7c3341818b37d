"""Port parity: the temporal propagation fill of the removal branch
(``restore.inpaint.restore_removal_temporal`` and its helpers,
``core.blocks.dilate_block_mask``) against ``elvis_tpu``, and the fill
through the pipeline's chunked temporal driver.

Tolerances: on uint8 frames the pixels outside the holes are bit-equal and
hole pixels differ by at most 1 LSB on at most 0.1% of them (the only
float work that can reorder is the blend's block means and the Jacobi
start); a static clip is bit-exact. The composed displacement fields agree
within 1e-4 px (the scatter inverse sums float weights in index order on
both sides). The chunked driver equals the unchunked call exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.core.blocks import dilate_block_mask as jdilate
from elvis_tpu.restore import inpaint as jinp
from elvis_tpu_torch.core.blocks import dilate_block_mask as tdilate
from elvis_tpu_torch.restore import inpaint as tinp

B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _holes(mask, b=B):
    return np.repeat(np.repeat(mask.astype(bool), b, 1), b, 2)


def _pan_clip(seed, n=6, h=48, w=64, dy=2, dx=3):
    """A band-limited canvas seen through a window that slides (dy, dx) px a
    frame: content moves by (-dy, -dx)."""
    rng = np.random.default_rng(seed)
    canvas = rng.random(((h + dy * n) // 4 + 1, (w + dx * n) // 4 + 1, 3)) * 200 + 20
    canvas = np.kron(canvas, np.ones((4, 4, 1)))
    canvas = canvas + rng.normal(0, 3, canvas.shape)
    clip = np.stack([canvas[dy * t: dy * t + h, dx * t: dx * t + w] for t in range(n)])
    return np.clip(clip, 0, 255).astype(np.uint8)


def _object_clip(seed, n=5, h=64, w=128):
    """A textured 16x16 object crossing a static background at +2 blocks a
    frame; holes on its leading block; the true per-pair field."""
    rng = np.random.default_rng(seed)
    bg = rng.random((h, w, 3)) * 255
    tex = rng.random((16, 16, 3)) * 255
    clip = np.empty((n, h, w, 3))
    mask = np.zeros((n, h // B, w // B), np.int8)
    truef = np.zeros((n, h // B, w // B, 2), np.float32)
    for t in range(n):
        clip[t] = bg
        x0 = 16 * t + 8
        clip[t, 32:48, x0:x0 + 16] = tex
        if 1 <= t <= 3:
            mask[t, 4, x0 // B] = 1
        if t >= 1:
            truef[t, 4, x0 // B:(x0 + 16) // B] = (0, 16.0)
    return clip.astype(np.uint8), mask, truef


def _pan_field(n, by, bx, seed):
    """The pan's true field (-2, -3) px with quarter-pel jitter on a third
    of the blocks (the hint's units), frame 0 zeros."""
    rng = np.random.default_rng(seed)
    f = np.broadcast_to(np.float32([-2.0, -3.0]), (n, by, bx, 2)).copy()
    jitter = rng.integers(-2, 3, (n, by, bx, 2)) / 4.0
    f += np.where(rng.random((n, by, bx, 1)) < 1 / 3, jitter, 0).astype(np.float32)
    f[0] = 0
    return f


def _both(frames, mask, **kw):
    j = np.asarray(jax.jit(lambda f, m: jinp.restore_removal_temporal(f, m, B, **kw))(
        jnp.asarray(frames), jnp.asarray(mask)))
    kw_t = {k: (torch.from_numpy(np.asarray(v)) if k == "motion_field" else v)
            for k, v in kw.items()}
    t = tinp.restore_removal_temporal(torch.from_numpy(frames), torch.from_numpy(mask), B,
                                      **kw_t).numpy()
    return t, j


def _assert_fill_close(t, j, mask):
    assert t.dtype == j.dtype == np.uint8 and t.shape == j.shape
    hole = _holes(mask)
    assert np.array_equal(t[~hole], j[~hole])  # known pixels: bit-equal
    d = np.abs(t[hole].astype(int) - j[hole].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("radius", [0, 1, 2, 9])
def test_dilate_block_mask(radius):
    rng = np.random.default_rng(radius)
    mask = rng.random((3, 6, 9)) < 0.15
    mask[0, 0, 0] = mask[1, -1, -1] = True  # corners: the edge must not wrap
    want = np.asarray(jdilate(jnp.asarray(mask), radius))
    got = tdilate(torch.from_numpy(mask.astype(np.int8)), radius)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["integer", "quarter_pel"])
def test_compose_displacements(kind):
    rng = np.random.default_rng(3)
    if kind == "integer":
        mv = rng.integers(-12, 13, (6, 5, 7, 2)).astype(np.float32)
    else:
        mv = (np.round(rng.normal(0, 6, (6, 5, 7, 2)) * 4) / 4).astype(np.float32)
    mv[0] = 0
    jb, jf = jinp._compose_displacements(jnp.asarray(mv), 4, B)
    tb, tf = tinp._compose_displacements(torch.from_numpy(mv), 4, B)
    assert len(tb) == len(tf) == 4
    for a, b in zip(jb + jf, tb + tf):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["estimated", "hint", "refs", "zero_motion"])
def test_fill_on_a_pan(variant):
    clip = _pan_clip(seed=1)
    n, h, w = clip.shape[:3]
    rng = np.random.default_rng(2)
    mask = (rng.random((n, h // B, w // B)) < 0.25).astype(np.int8)
    holed = np.where(_holes(mask)[..., None], 0, clip).astype(np.uint8)
    kw = {"estimated": {},
          "hint": {"motion_field": _pan_field(n, h // B, w // B, seed=4), "window": 3},
          "refs": {"ref_stride": 2, "max_refs": 2, "window": 2},
          "zero_motion": {"motion_radius": 0, "window": 3}}[variant]
    t, j = _both(holed, mask, **kw)
    _assert_fill_close(t, j, mask)


@pytest.mark.parametrize("variant", ["hint", "estimated"])
def test_fill_on_a_moving_object(variant):
    clip, mask, truef = _object_clip(seed=5)
    holed = np.where(_holes(mask)[..., None], 0, clip).astype(np.uint8)
    kw = {"window": 3}
    if variant == "hint":
        kw["motion_field"] = truef
    t, j = _both(holed, mask, **kw)
    _assert_fill_close(t, j, mask)
    if variant == "hint":
        # the composed trajectory reads the object's texture where the
        # co-located fill reads background (the JAX package's own bar)
        zero = tinp.restore_removal_temporal(torch.from_numpy(holed), torch.from_numpy(mask),
                                             B, window=3, motion_radius=0).numpy()
        hole = _holes(mask)

        def hole_mse(o):
            return float(((o.astype(float) - clip) ** 2).mean(-1)[hole].mean())

        assert hole_mse(t) * 4 < hole_mse(zero), (hole_mse(t), hole_mse(zero))


def test_static_clip_is_bit_exact():
    rng = np.random.default_rng(6)
    frame = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    clip = np.stack([frame] * 5)
    mask = (rng.random((5, 5, 7)) < 0.25).astype(np.int8)
    mask[:, 2, 3] = 0  # one block every frame keeps
    mask[0, 2, 3] = 1
    holed = np.where(_holes(mask)[..., None], 0, clip).astype(np.uint8)
    t, j = _both(holed, mask, window=4)
    np.testing.assert_array_equal(t, j)
    # every hole with a clean source somewhere in the clip comes back exactly
    sourced = _holes(mask & ~np.all(mask, axis=0, keepdims=True))
    np.testing.assert_array_equal(t[sourced], clip[sourced])


def test_fill_through_the_chunked_driver_equals_one_call():
    """The motion field rides the chunked temporal driver as one more
    frame-axis array: chunks of 4 frames with the backend's overlap give
    the one-call output exactly."""
    from elvis_tpu_torch.pipeline.config import ElvisConfig
    from elvis_tpu_torch.pipeline.run import _apply_inpaint_backend
    from elvis_tpu_torch.restore.backends import resolve_inpaint_backend

    clip = _pan_clip(seed=7, n=10)
    n, h, w = clip.shape[:3]
    rng = np.random.default_rng(8)
    mask = torch.from_numpy((rng.random((n, h // B, w // B)) < 0.2).astype(np.int8))
    holed = torch.from_numpy(np.where(_holes(mask.numpy())[..., None], 0, clip)
                             .astype(np.uint8))
    mv = torch.from_numpy(_pan_field(n, h // B, w // B, seed=9))
    cfg = ElvisConfig(propainter_neighbor_length=2, propainter_parallel_chunk_length=4)
    fn, prov = resolve_inpaint_backend("temporal", cfg, device="cpu")
    assert fn.temporal_overlap == 8 and fn.frame_chunk == 4 and "window=4" in prov
    chunked = _apply_inpaint_backend("temporal", fn, holed, mask, B, motion_field=mv)
    direct = fn(holed, mask, B, mv=mv)
    np.testing.assert_array_equal(chunked.numpy(), direct.numpy())


def test_propainter_resize_ratio_and_mask_dilation_match_jax():
    """The 'temporal' backend with ``propainter_resize_ratio`` (fill at half
    size, put back only the hole pixels) and ``propainter_mask_dilation``
    (16 px: four blocks of the half-size fill) against the JAX package's
    backend."""
    from elvis_tpu.pipeline.config import ElvisConfig as JConfig
    from elvis_tpu.restore.backends import resolve_inpaint_backend as jresolve
    from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig
    from elvis_tpu_torch.restore.backends import resolve_inpaint_backend as tresolve

    clip = _pan_clip(seed=10)
    n, h, w = clip.shape[:3]
    rng = np.random.default_rng(11)
    mask = (rng.random((n, h // B, w // B)) < 0.1).astype(np.int8)
    holed = np.where(_holes(mask)[..., None], 0, clip).astype(np.uint8)
    mv = _pan_field(n, h // B, w // B, seed=12)
    knobs = dict(propainter_resize_ratio=0.5, propainter_mask_dilation=16,
                 propainter_neighbor_length=1)
    jfn, jprov = jresolve("temporal", JConfig(**knobs))
    tfn, tprov = tresolve("temporal", TConfig(**knobs), device="cpu")
    assert tprov == jprov == "temporal_propagation[window=2,overlap=4,ref_stride=20]"
    j = np.asarray(jax.jit(lambda f, m, v: jfn(f, m, B, mv=v))(
        jnp.asarray(holed), jnp.asarray(mask), jnp.asarray(mv)))
    t = tfn(torch.from_numpy(holed), torch.from_numpy(mask), B, mv=torch.from_numpy(mv)).numpy()
    _assert_fill_close(t, j, mask)
    # known pixels never round-trip the resize
    assert np.array_equal(t[~_holes(mask)], holed[~_holes(mask)])
