"""Port parity: RRDB ``SRNet`` (``elvis_tpu_torch.models.srnet.SRNet``), its
bf16 export ``weights/srnet.npz``, the SR names 'srnet', 'srnet_ensemble' /
'ensemble', the generic slot's order, and the generic slot with a configured
``srnet_params_path`` (elvis_tpu_torch against elvis_tpu on the same numpy
inputs, on the CPU).

Tolerances, max / mean |port - JAX| on 0-255 output:
  * float32 on the same weights: ``ATOL_F32`` (2e-3, as the SRNetCompact
    tests: float32 convs summed in different orders, then the tail's 127.5).
  * bf16: ``BF16_TOL``. Every trunk value is bf16 in both packages (flax
    ``nn.Conv(dtype=bf16)`` casts input, kernel and bias, and the residual
    sums are bf16 arithmetic); the frameworks round the bf16 conv sums at
    different places. Measured on the CPU (torch against XLA): the
    flax-initialised weights at 1x12x16, full and phase output alike, 2.228 /
    0.224, where JAX's own bf16 model is 3.38 / 0.339 from its float32
    model; the shipped weights at 2x16x16, phase output, 0.247 / 0.041.
  * SR names on a uint8 4x64x48 clip through both ``resolve_sr_backend``:
    within 1 LSB and 0.1 LSB on average (the SR names' tolerance of
    ``tests/test_torch_srnet.py``); provenance JAX's with the port's
    weights files in place of the checkpoint directories.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.models import srnet as jsrnet
from elvis_tpu.models.io import load_params
from elvis_tpu_torch.models import io as tio
from elvis_tpu_torch.models import srnet as tsrnet

REPO = Path(__file__).resolve().parents[1]
ATOL_F32 = 2e-3
# (max, mean), the measured values above rounded up
BF16_TOL = {"random": (2.3, 0.23), "shipped": (0.26, 0.045)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def flax_params():
    """Flax-initialised RRDB params at full width (128/128/3), with the
    zero-initialised tail replaced by seeded N(0, 0.05) values: a zero tail
    makes the output the Lanczos base whatever the trunk computes."""
    params = jsrnet.SRNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    tail = params["params"]["tail"]
    tail["kernel"] = (rng.standard_normal(tail["kernel"].shape) * 0.05).astype(np.float32)
    tail["bias"] = (rng.standard_normal(tail["bias"].shape) * 0.05).astype(np.float32)
    return params


def _port_model(params, dtype):
    m = tsrnet.SRNet(dtype=dtype)
    m.load_state_dict(tio.params_from_flax(params))
    return m.eval().requires_grad_(False)


def test_rrdb_shape_and_layer_names(flax_params):
    leaves = jax.tree_util.tree_leaves(flax_params)
    assert len(leaves) == 56 and sum(x.size for x in leaves) == 9_595_395
    m = _port_model(flax_params, torch.bfloat16)
    assert sum(p.numel() for p in m.parameters()) == 9_595_395
    assert m.rrdb1.db0.conv2.weight.shape == (128, 384, 3, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", [False, True])
def test_rrdb_full_width_equals_flax(flax_params, dtype, phase):
    x = (np.random.default_rng(1).random((1, 12, 16, 3)) * 255).astype(np.float32)
    jm = jsrnet.SRNet(dtype=getattr(jnp, dtype), phase_output=phase)
    want = np.asarray(jm.apply(flax_params, jnp.asarray(x)))
    got = _port_model(flax_params, getattr(torch, dtype))(torch.from_numpy(x),
                                                          phase_output=phase).numpy()
    assert got.shape == want.shape == ((1, 12, 16, 2, 2, 3) if phase else (1, 24, 32, 3))
    err = np.abs(got - want)
    print(f"{dtype} phase={phase}: max {err.max():.4f} mean {err.mean():.4f}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32)
    else:
        assert err.max() <= BF16_TOL["random"][0] and err.mean() <= BF16_TOL["random"][1]
    assert np.abs(want - np.asarray(jm.apply(  # the tail reaches the output
        jax.tree_util.tree_map(np.zeros_like, flax_params), jnp.asarray(x)))).mean() > 1


def test_shipped_rrdb_equals_jax_restore():
    """weights/srnet.npz (bf16 trunk bits) against JAX's restore of
    checkpoints/srnet on a 2x16x16 clip, phase output."""
    jm = jsrnet.SRNet(phase_output=True)
    params = load_params(jm, str(REPO / "checkpoints" / "srnet"), jnp.zeros((1, 16, 16, 3)))
    x = (np.random.default_rng(0).random((2, 16, 16, 3)) * 255).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tio.load_srnet(tio.weights_path("srnet"), device="cpu")
    got = tsrnet.srnet_phase_fn(tm)(torch.from_numpy(x)).numpy()
    err = np.abs(got - want)
    print(f"shipped: max {err.max():.4f} mean {err.mean():.4f}")
    assert err.max() <= BF16_TOL["shipped"][0] and err.mean() <= BF16_TOL["shipped"][1]


@pytest.fixture(scope="module")
def sr_clip():
    """4 frames of 64x48 (a bilinear upscale of noise) and levels 0..2."""
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (4, 12, 16, 3)).astype(np.float32)
    frames = jax.image.resize(jnp.asarray(small), (4, 48, 64, 3), "linear")
    frames = np.round(np.asarray(frames)).astype(np.uint8)
    return frames, rng.integers(0, 3, (4, 6, 8)).astype(np.int32)


def _port_prov(jax_prov):
    return re.sub(r"/checkpoints/(\w+)", r"/elvis_tpu_torch/weights/\1.npz", jax_prov)


def _resolve_both(name, monkeypatch=None, hide=(), **cfg):
    from elvis_tpu.pipeline.config import ElvisConfig as JConfig
    from elvis_tpu.restore import backends as jb
    from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig
    from elvis_tpu_torch.restore import backends as tb

    for mod in (jb, tb):  # hide shipped tiers, as a checkout without their files
        real = mod.default_params_path
        monkeypatch.setattr(mod, "default_params_path",
                            lambda n, c, a, real=real: None if n in hide else real(n, c, a))
    return jb.resolve_sr_backend(name, JConfig(**cfg)), tb.resolve_sr_backend(
        name, TConfig(**cfg), device="cpu")


@pytest.mark.parametrize("name,hide", [
    ("srnet", ()),
    ("srnet_ensemble", ()),
    ("ensemble", ("srnet_large",)),  # two tiers: compact + RRDB
    ("realesrgan", ("srnet_student",)),  # generic: the ensemble after the student
])
def test_rrdb_and_ensemble_names_match_jax(sr_clip, name, hide, monkeypatch):
    frames, levels = sr_clip
    (jfn, jprov), (tfn, tprov) = _resolve_both(name, monkeypatch, hide)
    assert tprov == _port_prov(jprov)
    if name != "srnet":
        want_tiers = [t for t in ("srnet_compact", "srnet", "srnet_large") if t not in hide]
        assert "srnet_ensemble[" + " + ".join(f"{REPO}/checkpoints/{t}" for t in want_tiers) \
            in jprov
    want = np.asarray(jfn(jnp.asarray(frames), jnp.asarray(levels), 8))
    got = tfn(torch.from_numpy(frames), torch.from_numpy(levels), 8)
    assert got.dtype == torch.uint8
    err = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    print(f"{name}: max {err.max()} mean {err.mean():.4f}")
    assert err.max() <= 1 and err.mean() <= 0.1, (err.max(), err.mean())


@pytest.mark.parametrize("hide,want", [
    (("srnet_student", "srnet_large", "srnet_compact"), "srnet"),
    (("srnet_student", "srnet"), "srnet_ensemble"),  # compact + large
    (("srnet_student", "srnet", "srnet_compact"), "srnet_large"),
])
def test_generic_slot_order_matches_jax(hide, want, monkeypatch):
    """student > ensemble (two tiers at least) > large > compact > RRDB, for
    'realesrgan' and the names that take the generic tier."""
    for name in ("realesrgan", "hybrid", "level_seq", "naive_sr"):
        (_, jprov), (_, tprov) = _resolve_both(name, monkeypatch, hide)
        assert tprov == _port_prov(jprov), name
        assert f"{want}:" in jprov or f"{want}[" in jprov, (name, jprov)


@pytest.mark.parametrize("tier", ["srnet_compact", "srnet_large", "srnet"])
def test_configured_srnet_params_path_names_its_tier_as_jax(tier):
    """With ``srnet_params_path`` set the generic slot skips the student and
    the ensemble and names the first of large, compact, RRDB whose
    architecture the file holds, in both packages (up to the path)."""
    from elvis_tpu.pipeline.config import ElvisConfig as JConfig
    from elvis_tpu.restore.backends import resolve_sr_backend as jresolve
    from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend as tresolve

    jpath, tpath = str(REPO / "checkpoints" / tier), tio.weights_path(tier)
    _, jprov = jresolve("realesrgan", JConfig(srnet_params_path=jpath))
    _, tprov = tresolve("realesrgan", TConfig(srnet_params_path=tpath), device="cpu")
    assert jprov == f"progressive_neural[{tier}:{jpath}]"
    assert tprov == jprov.replace(jpath, tpath)
