"""Port parity: the pieces of the codec's device half, each against its JAX
counterpart on the same numpy inputs (elvis_tpu_torch against elvis_tpu, on
the CPU).

Tolerances: float results 1e-4 absolute (pixel scale 0-255); uint8 colour
results 1 LSB (a .5 tie may round either way); quantized levels, modes,
vectors, tables and the bit model exactly; costs 1e-3 relative; the Qstep
table 3e-7 relative (the port takes Qstep from a table made in float64, JAX
from a float32 ``exp2`` that is up to three ulps off: 7 of the 52 differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.codec.nvc import transform as jt
from elvis_tpu.ops import color as jcolor
from elvis_tpu.ops import dct as jdct
from elvis_tpu_torch.codec.nvc import transform as tt
from elvis_tpu_torch.ops import color as tcolor
from elvis_tpu_torch.ops import dct as tdct

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plane(rng, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(2 * np.pi * xx / 32) + 40 * np.cos(2 * np.pi * yy / 24)
    return np.clip(base + rng.normal(0, 6, (h, w)), 0, 255).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_yuv420_round_trip_matches(rng, dtype):
    rgb = (rng.random((3, 16, 24, 3)) * 255).astype(dtype)
    want = [np.asarray(a) for a in jcolor.rgb_to_yuv420(jnp.asarray(rgb))]
    got = [_np(a) for a in tcolor.rgb_to_yuv420(_t(rgb))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == np.uint8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=ATOL)
    back_w = np.asarray(jcolor.yuv420_to_rgb(*[jnp.asarray(a) for a in want]))
    back_g = _np(tcolor.yuv420_to_rgb(*[_t(a) for a in want]))
    assert back_g.dtype == back_w.dtype
    if dtype == np.uint8:
        assert np.abs(back_g.astype(int) - back_w.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(back_g, back_w, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_ycbcr_to_rgb_matches(rng, dtype):
    ycc = (rng.random((2, 8, 8, 3)) * 255).astype(dtype)
    want = np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(ycc)))
    got = _np(tcolor.ycbcr_to_rgb(_t(ycc)))
    assert got.dtype == want.dtype
    if dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_block_idct2_matches_and_inverts(rng):
    c = (rng.standard_normal((3, 4, 8, 8)) * 50).astype(np.float32)
    want = np.asarray(jdct.block_idct2(jnp.asarray(c)))
    got = tdct.block_idct2(_t(c))
    np.testing.assert_allclose(_np(got), want, atol=ATOL)
    np.testing.assert_allclose(_np(tdct.block_dct2(got)), c, atol=ATOL)


def test_qstep_table_within_one_ulp_of_jax():
    qp = np.arange(52)
    want = np.asarray(jt.qstep_from_qp(jnp.asarray(qp))).astype(np.float64)
    got = _np(tt.qstep_from_qp(_t(qp)))
    assert got.dtype == np.float32
    # JAX's float32 exp2 is up to three ulps from the true value (and its
    # jitted and eager results differ by 4.7e-7 between themselves)
    assert (np.abs(got - want) / want).max() <= 3e-7
    assert (got != want).sum() <= 8
    exact = np.exp2((qp - 4.0) / 6.0)
    assert (np.abs(got - exact) / exact).max() <= 6e-8  # the nearest float32
    assert got[4] == 1.0 and got[10] == 2.0 and got[28] == 16.0


def test_zigzag_and_selection_tables_equal():
    np.testing.assert_array_equal(tt.zigzag_order(8), jt.zigzag_order(8))
    for reach in (1, 2, 3):
        np.testing.assert_array_equal(tt._mc_selection_table(8, reach),
                                      jt._mc_selection_table(8, reach))
    for radius in (4, 7, 8, 12, 24, 56):
        assert tt._me_plan(radius) == jt._me_plan(radius)


def test_bit_model_exact_at_every_level():
    mags = np.arange(32768, dtype=np.float32)
    want = np.asarray(jnp.where(mags > 0, 2.0 * jnp.ceil(jnp.log2(mags + 1.0)) + 2.0, 0.05))
    np.testing.assert_array_equal(_np(tt._level_bits(_t(mags))), want)
    np.testing.assert_array_equal(_np(tt._level_bits(_t(mags[:8]), zero_bits=0.2))[0],
                                  np.float32(0.2))


@pytest.mark.parametrize("qp", [4, 22, 32, 45])
def test_quantize_and_rd_cost_match_on_the_same_qstep(rng, qp):
    coeffs = (rng.standard_normal((6, 8, 8, 8)) * rng.choice([2.0, 30.0, 400.0], (6, 8, 1, 1))
              ).astype(np.float32)
    qstep = np.asarray(jt.qstep_from_qp(jnp.full((6, 8), qp)))  # one array for both
    want = np.asarray(jt._quantize(jnp.asarray(coeffs), jnp.asarray(qstep)))
    got = tt._quantize(_t(coeffs), _t(qstep))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_allclose(
        _np(tt._dequantize(got, _t(qstep))),
        np.asarray(jt._dequantize(jnp.asarray(want), jnp.asarray(qstep))), rtol=1e-6)
    cost_w = np.asarray(jt._rd_cost(jnp.asarray(want), jnp.asarray(coeffs), jnp.asarray(qstep)))
    cost_g = _np(tt._rd_cost(got, _t(coeffs), _t(qstep)))
    np.testing.assert_allclose(cost_g, cost_w, rtol=1e-3)


def test_quantize_clips_to_int16(rng):
    coeffs = np.full((1, 1, 8, 8), 1e6, np.float32)
    coeffs[..., 1] *= -1
    got = _np(tt._quantize(_t(coeffs), torch.ones(1, 1)))
    assert got.max() == 32767 and got.min() == -32767


@pytest.mark.parametrize("qp", [24, 38])
def test_deblock_plane_matches(rng, qp):
    # a blocky plane: piecewise-constant blocks with small steps plus noise
    steps = rng.integers(-6, 7, (6, 8)).astype(np.float32)
    plane = 100 + np.kron(steps, np.ones((8, 8), np.float32)) + rng.normal(0, 0.5, (48, 64))
    plane = plane.astype(np.float32)
    qp_map = np.full((6, 8), qp) + rng.integers(-2, 3, (6, 8))
    want = np.asarray(jt.deblock_plane(jnp.asarray(plane), jt.qstep_from_qp(jnp.asarray(qp_map))))
    src = _t(plane)
    got = tt.deblock_plane(src, tt.qstep_from_qp(_t(qp_map)))
    np.testing.assert_allclose(_np(got), want, atol=ATOL)
    assert np.abs(want - plane).max() > 0.1  # the filter did something
    np.testing.assert_array_equal(_np(src), plane)  # and left its input alone
    # a batch of planes filters like each plane alone
    both = tt.deblock_plane(torch.stack([src, src.flip(0)]),
                            tt.qstep_from_qp(torch.stack([_t(qp_map), _t(qp_map).flip(0)])))
    np.testing.assert_array_equal(_np(both[0]), _np(got))


def test_intra_predictors_match(rng):
    top2 = (rng.random((8, 2, 8)) * 255).astype(np.float32)
    np.testing.assert_allclose(_np(tt._intra_predictors(_t(top2))),
                               np.asarray(jt._intra_predictors(jnp.asarray(top2))), atol=ATOL)


@pytest.mark.parametrize("qp", [26, 40])
def test_intra_frame_wavefront_matches(rng, qp):
    """Encode and decode wavefronts on one plane: levels and modes equal
    JAX's on nearly every block (a cost tie may flip one), reconstructions
    within 5e-4 where they are (a rounding of the prediction is carried down
    the rows and scaled by Qstep), and the port's decoder mirrors its
    encoder."""
    plane = _plane(rng)
    blocks = np.asarray(jt._blocks_of(jnp.asarray(plane)))
    qs = np.asarray(jt.qstep_from_qp(jnp.full((6, 8), qp)))
    lw, mw, rw = (np.asarray(a) for a in jt._intra_frame_encode(jnp.asarray(blocks),
                                                                jnp.asarray(qs)))
    lg, mg, rg = tt._intra_frame_encode(_t(blocks), _t(qs))
    assert lg.dtype == torch.int16 and mg.dtype == torch.int8
    same = (_np(mg) == mw) & (_np(lg) == lw).all(axis=(-2, -1))
    assert same.mean() >= 0.97, same.mean()
    if same.all():
        np.testing.assert_allclose(_np(rg), rw, atol=5e-4)
    assert set(np.unique(_np(mg))) <= {0, 4, 5, 6} and (_np(mg) >= 4).any()
    dec = tt._intra_frame_decode(lg.float(), mg, _t(qs))
    np.testing.assert_array_equal(_np(dec), _np(rg))
    dec_w = np.asarray(jt._intra_frame_decode(jnp.asarray(_np(lg), jnp.float32),
                                              jnp.asarray(_np(mg)), jnp.asarray(qs)))
    np.testing.assert_allclose(_np(dec), dec_w, atol=5e-4)
    cost_w = float(jt._intra_frame_rd(jnp.asarray(_np(lg)), jnp.asarray(blocks),
                                      jnp.asarray(_np(rg)), jnp.asarray(qs),
                                      jnp.asarray(_np(mg))))
    cost_g = float(tt._intra_frame_rd(lg, _t(blocks), rg, _t(qs), mg))
    assert abs(cost_g - cost_w) <= 1e-3 * abs(cost_w)


@pytest.mark.parametrize("reach", [1, 2])
def test_motion_predict_matches_integer_halfpel_and_out_of_frame(rng, reach):
    prev = _plane(rng)
    lim = 2 * reach * 8
    mv2 = rng.integers(-lim - 3, lim + 4, (6, 8, 2)).astype(np.int32)  # beyond the reach too
    mv2[0, 0] = (0, 0)
    mv2[0, 1] = (2, -4)       # integer
    mv2[0, 2] = (1, 1)        # half-pel both ways
    mv2[0, 3] = (-lim, -lim)  # out of the frame at the corner
    mv2[5, 7] = (lim, lim)
    want = np.asarray(jt._motion_predict(jnp.asarray(prev), jnp.asarray(mv2), reach=reach))
    got = _np(tt._motion_predict(_t(prev), _t(mv2), reach=reach))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[0, 0], prev[:8, :8])
    np.testing.assert_array_equal(got[0, 1], prev[1:9, 6:14])
    nb_w = np.asarray(jt._neighbourhood(jnp.asarray(prev), reach))
    np.testing.assert_array_equal(_np(tt._neighbourhood(_t(prev), reach)), nb_w)


def test_motion_search_finds_the_shift(rng):
    prev = rng.random((48, 64)).astype(np.float32) * 255
    cur = np.roll(prev, (2, -3), axis=(0, 1))  # cur[y, x] = prev[y - 2, x + 3]
    blocks = np.asarray(jt._blocks_of(jnp.asarray(cur)))
    want = np.asarray(jt._motion_search(jnp.asarray(prev), jnp.asarray(blocks), 4, 1))
    got = _np(tt._motion_search(_t(prev), _t(blocks), 4, 1))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, 3], (-2, 3))
    # a batch of references searches like each alone
    both = tt._motion_search(torch.stack([_t(prev), _t(cur)]),
                             torch.stack([_t(blocks), _t(blocks)]), 4, 1)
    np.testing.assert_array_equal(_np(both[0]), got)
    assert (_np(both[1]) == 0).all()


@pytest.mark.parametrize("radius", [4, 12])
def test_search_mv_matches(rng, radius):
    """The whole search (dense, or coarse + integer refinement, then
    half-pel) on a smooth moving plane: vectors equal JAX's on nearly every
    block (equal SADs may pick another of two equal candidates)."""
    yy, xx = np.mgrid[0:64, 0:96]
    def frame(dx):
        return (128 + 60 * np.sin(2 * np.pi * (xx + dx) / 37) * np.cos(2 * np.pi * yy / 29)
                ).astype(np.float32)
    shift = 2.5 if radius == 4 else 9.0
    prev = frame(0) + rng.normal(0, 2, (64, 96)).astype(np.float32)
    cur = frame(shift)
    blocks = np.asarray(jt._blocks_of(jnp.asarray(cur)))
    plan = jt._me_plan(radius)
    want = np.asarray(jt._search_mv(jnp.asarray(prev), jnp.asarray(blocks), radius, 1, True,
                                    *plan))
    got = _np(tt._search_mv(_t(prev), _t(blocks), radius, 1, True, *plan))
    share = (got == want).all(axis=-1).mean()
    print(f"radius {radius}: {share:.2%} of the vectors equal")
    assert share >= 0.95, share
    assert np.abs(got).max() > 2  # it moved
