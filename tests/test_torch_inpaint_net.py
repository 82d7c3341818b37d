"""Port parity: InpaintNet (``models.inpaint_net``), its loader, and the
'neural' inpaint backend (the ELVIS E2FGVI row's restorer) against
``elvis_tpu``, plus the backend's seed/post split and height tiling.

Tolerances: in float32 both nets agree within 1e-2 grey levels (max abs);
in bf16 the two packages' convolutions round differently, so the bar is
the one the deblur net is pinned to: hole PSNR against the clip within
0.05 dB a clip. The split (seed at its overlap, then the net at its own)
equals the fused backend exactly on the CPU, and so does the height-tiled
net (the same convolutions on windows that keep a 16-row halo). The
no-weights fallback (seed + 40 PDE iterations) is a uint8 fill held like
the temporal fill: bit-equal outside the holes, within 1 LSB on at most
0.1% of the hole pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.models import InpaintNet as JNet
from elvis_tpu.pipeline.config import ElvisConfig as JConfig
from elvis_tpu.restore.backends import resolve_inpaint_backend as jresolve
from elvis_tpu_torch.models.io import load_inpaint, weights_path
from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig
from elvis_tpu_torch.restore.backends import resolve_inpaint_backend as tresolve

B = 8
F32_ATOL = 1e-2
BF16_PSNR_DB = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jparams(_one_thread):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_weights import orbax_params

    return orbax_params("inpaint")


def _holes(mask):
    return np.repeat(np.repeat(mask.astype(bool), B, 1), B, 2)


def _clip(seed, n=6, h=48, w=64):
    """A smooth textured clip panning 2 px a frame, holes black, and its
    removal mask (a quarter of the blocks)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w + 2 * n]
    base = 128 + 60 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    canvas = np.stack([base, np.roll(base, 5, 1), np.roll(base, -3, 0)], -1)
    clip = np.stack([canvas[:, 2 * t: 2 * t + w] for t in range(n)])
    clip = np.clip(clip + rng.normal(0, 4, clip.shape), 0, 255).astype(np.uint8)
    mask = (rng.random((n, h // B, w // B)) < 0.25).astype(np.int8)
    holed = np.where(_holes(mask)[..., None], 0, clip).astype(np.uint8)
    return clip, holed, mask


def _hole_psnr(out, clip, mask):
    hole = _holes(mask)
    mse = ((np.asarray(out, np.float64) - clip) ** 2).mean(-1)[hole].mean()
    return 10 * np.log10(255.0 ** 2 / mse)


def test_loaded_state_equals_the_orbax_tree(jparams):
    """The converter descends into the gated convs' ``Conv_0``: every
    weight of the loaded module is the orbax leaf, HWIO -> OIHW."""
    net = load_inpaint(weights_path("inpaint"), device="cpu")
    sd = net.state_dict()
    leaves = {}
    for layer, node in jparams["params"].items():
        node = node.get("Conv_0", node)
        key = f"{layer}.Conv_0" if "Conv_0" in jparams["params"][layer] else layer
        leaves[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        leaves[f"{key}.bias"] = np.asarray(node["bias"])
    assert sorted(sd) == sorted(leaves) and len(leaves) == 16
    for k, v in leaves.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inpaint_net_matches_jax(jparams, dtype):
    clip, holed, mask = _clip(seed=1)
    seeded = np.where(_holes(mask)[..., None], 128, holed).astype(np.float32)
    from elvis_tpu_torch.models.inpaint_net import InpaintNet

    net = load_inpaint(weights_path("inpaint"), device="cpu")
    if dtype == "float32":
        f32 = InpaintNet(dtype=torch.float32)
        f32.load_state_dict(net.state_dict())
        net = f32.eval()
    j = np.asarray(JNet(dtype=getattr(jnp, dtype)).apply(jparams, jnp.asarray(seeded),
                                                          jnp.asarray(mask), B))
    with torch.no_grad():
        t = net(torch.from_numpy(seeded), torch.from_numpy(mask), B).numpy()
    assert t.dtype == np.float32 and t.shape == j.shape
    hole = _holes(mask)
    np.testing.assert_array_equal(t[~hole], seeded[~hole])  # only holes are touched
    if dtype == "float32":
        assert np.abs(t - j).max() <= F32_ATOL
    else:
        assert abs(_hole_psnr(t, clip, mask) - _hole_psnr(j, clip, mask)) <= BF16_PSNR_DB
        # the bar tells the net from no net: the identity reads 1.64 dB off
        assert _hole_psnr(t, clip, mask) - _hole_psnr(seeded, clip, mask) > 20 * BF16_PSNR_DB


def test_neural_backend_matches_jax():
    """The E2FGVI row's restorer on the same holed clip: the temporal seed
    and the bf16 net, hole PSNR within the bf16 bar."""
    clip, holed, mask = _clip(seed=2)
    jfn, jprov = jresolve("neural", JConfig())
    tfn, tprov = tresolve("neural", TConfig(), device="cpu")
    assert tprov == f"inpaint_net:{weights_path('inpaint')}[window=10,overlap=20]"
    assert jprov.endswith("[window=10,overlap=20]")
    j = np.asarray(jfn(jnp.asarray(holed), jnp.asarray(mask), B))
    t = tfn(torch.from_numpy(holed), torch.from_numpy(mask), B).numpy()
    assert t.dtype == j.dtype == np.float32
    assert abs(_hole_psnr(t, clip, mask) - _hole_psnr(j, clip, mask)) <= BF16_PSNR_DB
    # the seed alone (no net) reads 1.19 dB below: far outside the bar
    seed = tfn.split(torch.from_numpy(holed), torch.from_numpy(mask), B).numpy()
    assert _hole_psnr(t, clip, mask) - _hole_psnr(seed, clip, mask) > 20 * BF16_PSNR_DB
    for attr in ("temporal_overlap", "frame_chunk"):
        assert getattr(tfn, attr, None) == getattr(jfn, attr, None), attr
    for attr in ("temporal_overlap", "frame_chunk", "spatial_halo_rows"):
        assert getattr(tfn.split, attr, None) == getattr(jfn.split, attr, None), attr
        assert getattr(tfn.split.post, attr, None) == getattr(jfn.split.post, attr, None), attr


def test_seed_then_post_equals_the_fused_backend():
    """The pipeline's two-phase driver (seed at overlap 20, the net at
    overlap 2, frame chunks of 3) gives the fused call's output."""
    from elvis_tpu_torch.pipeline.run import _apply_inpaint_backend

    _, holed, mask = _clip(seed=3, n=8)
    fn, _ = tresolve("neural", TConfig(e2fgvi_parallel_chunk_length=3), device="cpu")
    assert fn.split.temporal_overlap == 20 and fn.split.post.temporal_overlap == 2
    assert fn.split.frame_chunk == fn.split.post.frame_chunk == 3
    f, m = torch.from_numpy(holed), torch.from_numpy(mask)
    split = _apply_inpaint_backend("neural", fn, f, m, B)
    np.testing.assert_array_equal(split.numpy(), fn(f, m, B).numpy())


def test_post_height_tiled_equals_untiled():
    """Under a pixel budget that forces height tiles (16-row halo), the net
    gives its untiled output."""
    from elvis_tpu_torch.pipeline.run import _apply_temporal, _carry_tiling, _height_tile_plan

    _, holed, mask = _clip(seed=4, n=4, h=96, w=64)
    fn, _ = tresolve("neural", TConfig(), device="cpu")
    post = fn.split.post
    seeded = fn.split(torch.from_numpy(holed), torch.from_numpy(mask), B)
    m = torch.from_numpy(mask)

    def call(f, mm):
        return post(f, mm, B)

    call = _carry_tiling(call, post)
    call.spatial_pixel_budget = 4 * 56 * 64  # windows of 56 rows: 24 kept + 2 x 16 halo
    plan = _height_tile_plan(call, seeded.shape, 4)
    assert plan == (16, 56)
    tiled = _apply_temporal(call, (seeded, m), overlap=post.temporal_overlap)
    np.testing.assert_array_equal(tiled.numpy(), post(seeded, m, B).numpy())


def test_no_weights_fallback_matches_jax():
    clip, holed, mask = _clip(seed=5)
    jfn, jprov = jresolve("neural", JConfig(auto_load_checkpoints=False))
    tfn, tprov = tresolve("neural", TConfig(auto_load_checkpoints=False), device="cpu")
    assert tprov == jprov == "temporal+pde (no inpaint checkpoint)[window=10]"
    assert tfn.temporal_overlap == jfn.temporal_overlap == 20
    assert not hasattr(tfn, "split")
    j = np.asarray(jfn(jnp.asarray(holed), jnp.asarray(mask), B))
    t = tfn(torch.from_numpy(holed), torch.from_numpy(mask), B).numpy()
    assert t.dtype == j.dtype == np.uint8
    hole = _holes(mask)
    assert np.array_equal(t[~hole], j[~hole])
    d = np.abs(t[hole].astype(int) - j[hole].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
