"""Port parity: ``elvis_tpu_torch.parallel`` (mesh, halo exchange), the tile
helpers of ``restore.temporal`` and the mesh branch of ``run_elvis``, against
the JAX package on its CPU mesh with the same shard count.

torch has no virtual CPU devices: the port's meshes here are logical shards
on ``cpu``, made by replacing ``parallel.mesh.devices`` (the port's
``jax.devices()``), as the JAX package's tests get eight CPU devices from
``XLA_FLAGS``. Inputs come from a numpy seed. Tolerances: the halo functions
on float data equal the JAX functions and the unsharded calls to 1e-6 (the
same arithmetic per element); the progressive restore through
``spatial_tile_map_blocks`` within 0.1 grey level max and 1e-3 mean of the
unsharded restore (the JAX package's own bound), and within 1e-3 of JAX's
sharded result; the temporal fill and the tile helpers on uint8 exactly;
``run_elvis`` rows within PR 5's tolerances of JAX's sharded run (bitrate
1%, PSNR 0.1 dB, SSIM 2e-3, LPIPS 1e-3, MSE 1%) and equal to the port's
unsharded run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.parallel import make_mesh as jmake_mesh
from elvis_tpu.parallel import mesh as jmesh
from elvis_tpu.parallel.halo import spatial_tile_map as jspatial
from elvis_tpu.parallel.halo import spatial_tile_map_blocks as jspatial_blocks
from elvis_tpu.parallel.halo import temporal_map_overlap as jtemporal
from elvis_tpu_torch.parallel import mesh as tmesh
from elvis_tpu_torch.parallel import (
    make_mesh,
    resolve_devices,
    shard_frames,
    spatial_tile_map,
    spatial_tile_map_blocks,
    temporal_map_overlap,
)

CPU = torch.device("cpu")
BITRATE_RTOL, PSNR_ATOL_DB, SSIM_ATOL, LPIPS_ATOL, MSE_RTOL = 0.01, 0.1, 2e-3, 1e-3, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def logical(monkeypatch):
    """``k`` logical CPU devices for the port (8 by default)."""

    def use(k=8):
        monkeypatch.setattr(tmesh, "devices", lambda device_type="cuda": [CPU] * k)

    use()
    return use


def _tfilter(e):
    """3-tap temporal mean with edge padding (torch)."""
    p = torch.cat([e[:1], e, e[-1:]])
    return (p[:-2] + p[1:-1] + p[2:]) / 3.0


def _jfilter(e):
    p = jnp.concatenate([e[:1], e, e[-1:]])
    return (p[:-2] + p[1:-1] + p[2:]) / 3.0


def test_devices_resolve_like_jax(logical):
    got = resolve_devices([0, 3, "cpu:1", 0], device_type="cpu")
    want = jmesh.resolve_devices([0, 3, "cpu:1", 0])
    assert len(got) == len(want) == 3 and [d.id for d in want] == [0, 3, 1]
    assert resolve_devices([torch.device("cpu")], device_type="cpu") == [CPU]
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError):
            mod.resolve_devices([99])
    assert tmesh.devices("cuda") == [CPU] * 8  # the replaced function, any type
    logical(1)
    assert len(resolve_devices(None, device_type="cpu")) == 1


@pytest.mark.parametrize("axes,shape", [
    ((("data", -1),), {"data": 8}),
    ((("data", -1), ("tensor", 2)), {"data": 4, "tensor": 2}),
    ((("data", 2), ("spatial", 4)), {"data": 2, "spatial": 4}),
])
def test_make_mesh_shapes_equal_jax(logical, axes, shape):
    m = make_mesh(axes, device_type="cpu")
    assert m.shape == dict(jmake_mesh(axes).shape) == shape
    assert m.devices.shape == tuple(shape.values())


@pytest.mark.parametrize("axes", [(("data", 3),), (("data", -1), ("tensor", -1)),
                                  (("data", -1), ("tensor", 3))])
def test_make_mesh_errors_as_jax(logical, axes):
    with pytest.raises(ValueError):
        make_mesh(axes, device_type="cpu")
    with pytest.raises(ValueError):
        jmake_mesh(axes)


@pytest.mark.parametrize("n", [13, 16])
def test_shard_frames_pads_with_edge_repeats_as_jax(logical, n):
    x = np.random.default_rng(n).random((n, 4, 4, 3)).astype(np.float32)
    sharded, got_n = shard_frames(torch.from_numpy(x), make_mesh(device_type="cpu"))
    jsharded, jn = jmesh.shard_frames(jnp.asarray(x), jmake_mesh())
    assert got_n == jn == n and sharded.shape == tuple(jsharded.shape) == (16, 4, 4, 3)
    assert len(sharded.shards) == 8 and {tuple(s.shape) for s in sharded.shards} == {(2, 4, 4, 3)}
    np.testing.assert_array_equal(sharded.gather().numpy(), np.asarray(jsharded))


@pytest.mark.parametrize("k,overlap", [(2, 1), (4, 1), (4, 3), (8, 2)])
def test_temporal_halo_equals_jax_and_unsharded(logical, k, overlap):
    """A neighbour-sensitive temporal filter (a 3-tap mean, applied twice
    when the halo allows) gives the same frames sharded as unsharded: the
    shards see their neighbours' frames, the clip's ends edge replicas."""
    x = np.random.default_rng(k).random((16, 6, 5, 3)).astype(np.float32)
    taps = min(overlap, 2)

    def tf(e):
        for _ in range(taps):
            e = _tfilter(e)
        return e

    def jf(e):
        for _ in range(taps):
            e = _jfilter(e)
        return e

    mesh = make_mesh(devices=list(range(k)), device_type="cpu")
    got = temporal_map_overlap(tf, torch.from_numpy(x), mesh, overlap).numpy()
    want = np.asarray(jtemporal(jf, jnp.asarray(x), jmake_mesh(devices=list(range(k))),
                                overlap))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # unsharded, on the clip with the same edge replicas (a two-pass filter
    # sees them at the clip's ends)
    t = torch.from_numpy(x)
    padded = torch.cat([t[:1].repeat(overlap, 1, 1, 1), t, t[-1:].repeat(overlap, 1, 1, 1)])
    np.testing.assert_allclose(got, tf(padded)[overlap:-overlap].numpy(), atol=1e-6)


def test_temporal_halo_takes_tuples_and_checks_its_preconditions(logical):
    x = torch.from_numpy(np.random.default_rng(0).random((8, 4, 4, 3)).astype(np.float32))
    m = (x[..., 0] > 0.5).to(torch.int8)
    mesh = make_mesh(devices=[0, 1, 2, 3], device_type="cpu")
    got = temporal_map_overlap(lambda f, mm: f * mm[..., None], (x, m), mesh, overlap=2)
    torch.testing.assert_close(got, x * m[..., None])
    with pytest.raises(ValueError, match="not divisible"):
        temporal_map_overlap(lambda e: e, x[:7], mesh, 1)
    with pytest.raises(ValueError, match="smaller than overlap"):
        temporal_map_overlap(lambda e: e, x, mesh, 3)
    with pytest.raises(AssertionError):  # the JAX package asserts the same
        jtemporal(lambda e: e, jnp.ones((7, 4, 4, 3)), jmake_mesh(devices=[0, 1, 2, 3]), 1)


@pytest.mark.parametrize("k,halo", [(4, 1), (8, 2)])
def test_spatial_halo_equals_jax_and_unsharded(logical, k, halo):
    """A vertical 3-tap blur, ``halo`` passes, across row shards equals
    JAX's and the unsharded blur of the frame with ``halo`` edge rows."""
    x = np.random.default_rng(1).random((2, 64, 16, 3)).astype(np.float32)

    def vblur(e):
        for _ in range(halo):
            p = torch.cat([e[:, :1], e, e[:, -1:]], dim=1)
            e = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0
        return e

    def jblur(e):
        for _ in range(halo):
            p = jnp.concatenate([e[:, :1], e, e[:, -1:]], axis=1)
            e = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0
        return e

    mesh = make_mesh((("spatial", k),), devices=list(range(k)), device_type="cpu")
    got = spatial_tile_map(vblur, torch.from_numpy(x), mesh, halo).numpy()
    want = np.asarray(jspatial(jblur, jnp.asarray(x),
                               jmake_mesh((("spatial", k),), devices=list(range(k))), halo))
    np.testing.assert_allclose(got, want, atol=1e-6)
    t = torch.from_numpy(x)
    padded = torch.cat([t[:, :1].repeat(1, halo, 1, 1), t, t[:, -1:].repeat(1, halo, 1, 1)], 1)
    np.testing.assert_allclose(got, vblur(padded)[:, halo:-halo].numpy(), atol=1e-6)


def test_spatial_blocks_progressive_restore_equals_jax_and_unsharded(logical):
    """The progressive restore (Lanczos, max_level 3) height-sharded with a
    32-row halo and the slid edge windows on a data 2 x spatial 2 mesh
    equals the unsharded restore, as JAX's does (its bound: 0.1 max, 1e-3
    mean), and JAX's sharded result."""
    from elvis_tpu.degrade import adaptive_downsample as jdown
    from elvis_tpu.restore import progressive_restore as jrestore
    from elvis_tpu.restore.progressive import lanczos_upsample_2x as jlanczos
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.restore import progressive_restore
    from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x

    rng = np.random.default_rng(2)
    b, n, h, w = 8, 2, 128, 32
    frames = (rng.random((n, h, w, 3)) * 255).astype(np.float32)
    scores = rng.random((n, h // b, w // b)).astype(np.float32)
    jd, jl = jdown(jnp.asarray(frames), jnp.asarray(scores), b)
    # both packages' restores on the SAME degraded input (JAX's)
    td, tl = torch.from_numpy(np.asarray(jd)), torch.from_numpy(np.asarray(jl))
    assert torch.equal(adaptive_downsample(torch.from_numpy(frames), torch.from_numpy(scores),
                                           b)[1], tl)

    def restore(f, lv):
        return progressive_restore(f, lv, b, upsample_fn=lanczos_upsample_2x)

    devs = [0, 1, 2, 3]
    axes = (("data", 2), ("spatial", 2))
    got = spatial_tile_map_blocks(restore, td, tl, make_mesh(axes, devices=devs,
                                                             device_type="cpu"),
                                  halo=32, block_size=b, data_axis="data").numpy()
    want = np.asarray(jspatial_blocks(lambda f, lv: jrestore(f, lv, b, upsample_fn=jlanczos),
                                      jd, jl, jmake_mesh(axes, devices=devs), halo=32,
                                      block_size=b, data_axis="data"))
    ref = restore(td, tl).numpy()
    err = np.abs(got - ref)
    assert err.max() < 0.1 and err.mean() < 1e-3, (err.max(), err.mean())
    assert np.abs(got - want).max() < 1e-3
    # no data axis: the frame axis whole on each of the 2 tiles
    two = spatial_tile_map_blocks(restore, td, tl, make_mesh((("spatial", 2),), devices=[0, 1],
                                                             device_type="cpu"),
                                  halo=32, block_size=b).numpy()
    err = np.abs(two - ref)
    assert err.max() < 0.1 and err.mean() < 1e-3, (err.max(), err.mean())


def test_spatial_blocks_preconditions(logical):
    mesh = make_mesh((("spatial", 4),), devices=[0, 1, 2, 3], device_type="cpu")
    f, lv = torch.zeros((1, 256, 16, 3)), torch.zeros((1, 32, 2), dtype=torch.int32)
    for halo, frames, match in ((12, f, "multiple"), (32, f[:, :240], "divisible"),
                                (40, f, "2\\*halo")):
        with pytest.raises(ValueError, match=match):
            spatial_tile_map_blocks(lambda a, b: a, frames, lv, mesh, halo, 8)


def test_temporal_fill_sharded_equals_unsharded(logical):
    """``restore_removal_temporal`` through ``temporal_map_overlap`` with
    overlap = 2 * window equals the whole-clip fill bit for bit (uint8), as
    the JAX package's test of the same holds for its own (the port's fill
    is held to JAX's in tests/test_torch_inpaint_temporal.py)."""
    from elvis_tpu_torch.core.blocks import upsample_map
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal

    rng = np.random.default_rng(3)
    n, h, w, pan = 24, 24, 32, 2
    wide = (rng.random((h, w + pan * n, 3)) * 255).astype(np.float32)
    clip = torch.from_numpy(np.stack([wide[:, pan * t: pan * t + w]
                                      for t in range(n)]).astype(np.uint8))
    mask = torch.from_numpy((rng.random((n, h // 8, w // 8)) < 0.2).astype(np.int8))
    holed = torch.where(upsample_map(mask.bool(), 8)[..., None], 0, clip).to(torch.uint8)
    fn = functools.partial(restore_removal_temporal, block_size=8, window=1, motion_radius=2)
    got = temporal_map_overlap(lambda f, m: fn(f, m), (holed, mask),
                               make_mesh(device_type="cpu"), overlap=2)
    assert torch.equal(got, fn(holed, mask))


def _hinted_pan(n, h=24, w=32, pan=8, seed=13):
    """A clip panning ``pan`` px (a block) a frame to the left, 20% of its
    blocks holed, and the pan's true per-pair motion field (frame 0 zeros),
    as the client's motion hint gives it. The last frame's one hole has a
    hole as its source in the frame before, so only a frame after the clip
    could fill it by propagation: where the halo claims one."""
    from elvis_tpu_torch.core.blocks import upsample_map

    rng = np.random.default_rng(seed)
    wide = (rng.random((h, w + pan * n, 3)) * 255).astype(np.float32)
    clip = torch.from_numpy(np.stack([wide[:, pan * t: pan * t + w]
                                      for t in range(n)]).astype(np.uint8))
    masks = (rng.random((n, h // 8, w // 8)) < 0.2).astype(np.int8)
    masks[-2:] = 0
    masks[-1, 1, 1] = masks[-2, 1, 2] = 1
    mask = torch.from_numpy(masks)
    holed = torch.where(upsample_map(mask.bool(), 8)[..., None], 0, clip).to(torch.uint8)
    field = torch.zeros((n, h // 8, w // 8, 2))
    field[1:, ..., 1] = -float(pan)
    return holed, mask, field


def _hinted_fill(f, m, mv):
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal

    return restore_removal_temporal(f, m, 8, window=1, motion_radius=2, motion_field=mv)


@pytest.mark.parametrize("k,n", [(2, 8), (4, 8), (2, 7)])
def test_temporal_fill_with_the_motion_hint_sharded_equals_unsharded(k, n, logical):
    """The motion field is per pair: past the clip's end, where the halo
    repeats the last frame, it is zero motion (``zero_edge``), so the fill
    with the hint through ``temporal_map_overlap`` (overlap 2 = 2 * window)
    equals the whole-clip fill bit for bit; through ``_DataParallel``
    too, whose padding of 7 frames to 8 adds one zero-motion frame."""
    from elvis_tpu_torch.pipeline.run import _DataParallel

    holed, mask, field = _hinted_pan(n)
    whole = _hinted_fill(holed, mask, field)
    logical(k)
    if n % k == 0:
        got = temporal_map_overlap(_hinted_fill, (holed, mask, field),
                                   make_mesh(device_type="cpu"), overlap=2,
                                   zero_edge=(False, False, True))
        assert torch.equal(got, whole)
    dp = _DataParallel(True, device_type="cpu")
    got = dp.apply_temporal(_hinted_fill, (holed, mask, field), overlap=2,
                            pairwise=(False, False, True))
    assert torch.equal(got, whole)


@pytest.fixture(scope="module")
def jax_hinted_fills():
    """JAX's fill with the hint over 2 shards of its CPU mesh and whole."""
    from elvis_tpu.restore.inpaint import restore_removal_temporal as jfill

    holed, mask, field = (x.numpy() for x in _hinted_pan(8))

    def fn(f, m, mv):
        return jfill(f, m, 8, window=1, motion_radius=2, motion_field=mv)

    args = tuple(jnp.asarray(x) for x in (holed, mask, field))
    mesh = jmake_mesh(devices=[0, 1])
    sharded = np.asarray(jax.jit(lambda *a: jtemporal(fn, a, mesh, 2))(*args))
    return sharded, np.asarray(jax.jit(fn)(*args))


def test_motion_hint_halo_diverges_from_jax_sharded_on_the_last_frame(jax_hinted_fills, logical):
    """An intended divergence: JAX's halo replicates the last pair's motion
    between copies of the last frame, so its sharded fill with the hint
    differs from its whole-clip fill on the last frame (64 LSB on this
    pan), and only there. The port's sharded fill equals JAX's
    WHOLE-clip fill (the fill's own tolerance: known pixels bit-equal, hole
    pixels within 1 LSB on at most 0.1%, tests/test_torch_inpaint_temporal.py)."""
    jsharded, jwhole = jax_hinted_fills
    holed, mask, field = _hinted_pan(8)
    logical(2)
    got = temporal_map_overlap(_hinted_fill, (holed, mask, field), make_mesh(device_type="cpu"),
                               overlap=2, zero_edge=(False, False, True)).numpy()
    hole = np.repeat(np.repeat(mask.numpy().astype(bool), 8, 1), 8, 2)
    assert np.array_equal(got[~hole], jwhole[~hole])
    d = np.abs(got[hole].astype(int) - jwhole[hole].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    by_frame = np.abs(got.astype(int) - jsharded.astype(int)).max(axis=(1, 2, 3))
    assert by_frame[:-1].max() <= 1 and by_frame[-1] >= 20, by_frame


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("tile,halo", [(8, 2), (16, 4)])
def test_tile_helpers_equal_jax(dtype, tile, halo):
    from elvis_tpu.restore.temporal import extract_halo_tiles as jextract
    from elvis_tpu.restore.temporal import feathered_tile_apply as jfeather
    from elvis_tpu_torch.restore.temporal import extract_halo_tiles, feathered_tile_apply

    x = (np.random.default_rng(tile).random((2, 32, 48, 3)) * 255).astype(dtype)
    tiles = extract_halo_tiles(torch.from_numpy(x), tile, halo)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jextract(jnp.asarray(x), tile, halo)))
    assert tiles.dtype == torch.from_numpy(x).dtype

    def tfn(t):  # neighbour-sensitive: a 3x3 box blur inside each tile
        p = torch.nn.functional.pad(t.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
        return torch.nn.functional.avg_pool2d(p, 3, 1).permute(0, 2, 3, 1) + 3.0

    def jfn(t):
        p = jnp.pad(t, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        acc = sum(p[:, i: i + t.shape[1], j: j + t.shape[2]] for i in range(3) for j in range(3))
        return acc / 9.0 + 3.0

    got = feathered_tile_apply(torch.from_numpy(x), tfn, tile, halo).numpy()
    want = np.asarray(jfeather(jnp.asarray(x), jfn, tile, halo))
    assert got.dtype == want.dtype == dtype
    if dtype == np.uint8:
        # a value within float error of a .5 tie may round apart
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got != want).mean() < 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-3)
    ident = feathered_tile_apply(torch.from_numpy(x), lambda t: t, tile, halo).numpy()
    np.testing.assert_allclose(ident.astype(np.float32), x.astype(np.float32), atol=1e-3)


def test_dataparallel_sharded_calls_equal_unsharded(logical, monkeypatch):
    """``_DataParallel.apply`` (13 frames over 4 shards: padded and trimmed)
    and ``apply_temporal`` (a +-1-frame mean with a 2-frame halo) equal the
    one-card chunked calls, which stay exact with 3-frame chunks; a stage's list of
    one device means no mesh."""
    from elvis_tpu_torch.pipeline import run as trun

    logical(4)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((13, 8, 8, 3)).astype(np.float32))
    m = torch.from_numpy((rng.random((13, 1, 1)) < 0.5).astype(np.int8))
    dp = trun._DataParallel(True, device_type="cpu")
    assert dp.mesh.shape == {"data": 4} and dp.spatial_mesh is None
    assert dp._mesh_for([2]) is None and dp._mesh_for([0, "cpu:2"]).shape == {"data": 2}
    assert trun._DataParallel(False, device_type="cpu").mesh is None
    calls = []

    def fn(a, mm):
        calls.append(a.shape[0])
        return a * 2.0 + mm[..., None]

    want = x * 2.0 + m[..., None]
    torch.testing.assert_close(dp.apply(fn, x, m), want)
    assert calls == [4, 4, 4, 4]  # 13 frames padded to 16 over 4 shards
    # a backend resolved on the run's device is not resolved again for a
    # shard on that device (cpu and cpu:0 are one device)
    made = []
    per_device = trun._PerDevice(lambda d: made.append(d) or fn, {CPU: fn})
    torch.testing.assert_close(dp.apply(per_device.map(lambda g: g), x, m), want)
    assert per_device.on(torch.device("cpu", 0)) is fn and made == []
    torch.testing.assert_close(dp.apply(fn, x, m, devices=[0, 1]), want)
    monkeypatch.setattr(trun, "_FRAME_CHUNK_PIXEL_BUDGET", 3 * 8 * 8)  # 3-frame chunks
    torch.testing.assert_close(trun._DataParallel(False).apply(fn, x, m), want)

    def smooth(a):
        return (torch.cat([a[:1], a[:-1]]) + a + torch.cat([a[1:], a[-1:]])) / 3.0

    full = smooth(x[:12])
    torch.testing.assert_close(dp.apply_temporal(smooth, (x[:12],), overlap=2), full)
    torch.testing.assert_close(trun._DataParallel(False).apply_temporal(smooth, (x[:12],), 2),
                               full)
    # a shard smaller than the window: the unsharded call
    torch.testing.assert_close(dp.apply_temporal(smooth, (x[:12],), overlap=4), full)


def _rows(r):
    return [k for k, v in r.items() if isinstance(v, dict) and "foreground" in v]


def _rows_close(a, b):
    assert abs(a["bitrate_mbps"] - b["bitrate_mbps"]) <= BITRATE_RTOL * b["bitrate_mbps"]
    for region in ("foreground", "background"):
        x, y = a[region], b[region]
        assert abs(x["psnr_mean"] - y["psnr_mean"]) <= PSNR_ATOL_DB, region
        assert abs(x["ssim_mean"] - y["ssim_mean"]) <= SSIM_ATOL, region
        assert abs(x["lpips_mean"] - y["lpips_mean"]) <= LPIPS_ATOL, region
        assert abs(x["mse_mean"] - y["mse_mean"]) <= MSE_RTOL * y["mse_mean"], region


RUN = dict(reference_video="synthetic://moving?frames=5&fps=30", width=48, height=32,
           inpaint_backends=["diffusion"], enable_fvmd=False, enable_vmaf=False,
           stage_cache=False, target_bitrate_override=100_000, verbose=False)


def test_run_elvis_over_four_shards_equals_jax_and_unsharded(logical, monkeypatch, tmp_path):
    """``run_elvis`` with ``data_parallel`` over 4 logical shards (5 frames:
    the padding path) against JAX's sharded run over 4 of its CPU devices,
    and against the port's unsharded run; the per-frame stages shard."""
    from elvis_tpu.pipeline import ElvisConfig as JConfig, run_elvis as jrun
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.pipeline import run as trun

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:4])
    j = jrun(JConfig(experiment_dir=str(tmp_path / "jax"), **RUN))
    monkeypatch.setattr(jax, "devices", real)

    logical(1)
    one = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "one"), **RUN), device="cpu")
    logical(4)
    sharded_calls = []
    real_shard = trun.shard_frames

    def spy(a, mesh, axis="data"):
        sharded_calls.append(mesh.shape[axis])
        return real_shard(a, mesh, axis)

    monkeypatch.setattr(trun, "shard_frames", spy)
    t = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "four"), **RUN), device="cpu")
    # stretch, the fill, SR, deblur, Lanczos, unsharp: two arrays each
    assert sharded_calls == [4] * 12
    assert _rows(t) == _rows(j) == _rows(one) and len(_rows(t)) == 7
    for row in _rows(t):
        _rows_close(t[row], j[row])
        for region in ("foreground", "background"):
            assert t[row][region]["psnr_mean"] == pytest.approx(one[row][region]["psnr_mean"],
                                                                abs=1e-4)


def test_run_elvis_routes_tall_frames_through_tiles(logical, monkeypatch, tmp_path):
    """``spatial_devices`` and a low threshold send the SR and deblur
    restores through ``apply_spatial`` (a data 1 x spatial 4 mesh); the rows
    are within PR 5's PSNR bound of the unsharded run's. One device, or a spatial size that does not
    divide the devices, builds no spatial mesh."""
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.pipeline import run as trun

    cfg = dict(RUN, width=48, height=128, reference_video="synthetic://moving?frames=4&fps=24",
               spatial_devices=4, spatial_tile_threshold=128, spatial_halo=16,
               generate_opencv_benchmarks=False)
    logical(1)
    one = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "one"), **cfg), device="cpu")
    logical(4)
    assert trun._DataParallel(True, spatial=3, device_type="cpu").spatial_mesh is None
    assert trun._DataParallel(True, spatial=4, device_type="cpu").spatial_mesh.shape == \
        {"data": 1, "spatial": 4}
    routed = []
    real = trun._DataParallel.apply_spatial

    def spy(self, fn, frames, levels, halo, block_size):
        routed.append((tuple(frames.shape), halo))
        return real(self, fn, frames, levels, halo, block_size)

    monkeypatch.setattr(trun._DataParallel, "apply_spatial", spy)
    t = run_elvis(ElvisConfig(experiment_dir=str(tmp_path / "tiles"), **cfg), device="cpu")
    assert routed == [((4, 128, 48, 3), 16)] * 2  # SR, then deblur
    assert _rows(t) == _rows(one)
    for row in _rows(t):
        for region in ("foreground", "background"):
            # a 16-row halo is less than the nets' receptive fields: PR 5's bound
            assert abs(t[row][region]["psnr_mean"] - one[row][region]["psnr_mean"]) <= \
                PSNR_ATOL_DB
