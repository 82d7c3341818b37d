"""Port parity: the SRNetCompact family and its weight converter
(elvis_tpu_torch against elvis_tpu on the same numpy inputs, on the CPU).

Tolerances:
  * float32 models (``dtype=jnp.float32`` in flax, ``torch.float32`` in the
    port) on random weights: ``atol=2e-3`` on 0-255 output. Both sides sum
    the 3x3 convs in float32 in different orders; the residual tail scales
    the last conv by 127.5, which turns ~1e-5 relative trunk differences
    into ~1e-3 absolute output differences.
  * bf16 models on the committed weights: see ``BF16_TOL``; the same
    weights in float32 are held to ``atol=2e-3``.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.models import srnet as jsrnet
from elvis_tpu.models.io import load_params
from elvis_tpu_torch.models import io as tio
from elvis_tpu_torch.models import srnet as tsrnet
from elvis_tpu_torch.ops.resize import interleave_phases

REPO = Path(__file__).resolve().parents[1]
ATOL_F32 = 2e-3
# bf16 trunk on the shipped weights, 2x16x16 input from the seed-0 rng,
# max / mean |port - JAX| on 0-255 output, measured on the CPU (torch 2.13
# vs XLA): compact 1.08 / 0.167, student 0.517 / 0.088. That is bf16
# rounding noise, not a fault: the two frameworks round the bf16 conv sums
# at different places, and single bf16 ulps (1/128 relative) of the up
# conv reach the f32 tail scaled by 127.5. JAX's own bf16 model differs
# from its f32 model by as much (0.88 / 0.160 and 0.513 / 0.079), while
# the port's f32 model on the same weights is within 2e-4 of JAX's.
# Pinned at the measured values rounded up: (max, mean).
BF16_TOL = {"srnet_compact": (1.1, 0.17), "srnet_student": (0.52, 0.09)}
META = {"srnet_compact": (128, 5), "srnet_student": (256, 6)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_flax_params(model, rng, hw=8):
    shapes = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, hw, hw, 3)))

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) == 4 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes)


def _torch_model(params, features, num_convs, dtype):
    m = tsrnet.SRNetCompact(features=features, num_convs=num_convs, dtype=dtype)
    m.load_state_dict(tio.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return m.eval().requires_grad_(False)


def test_phase_kernel_select_exact():
    np.testing.assert_array_equal(tsrnet._phase_kernel_select(), jsrnet._phase_kernel_select())


@pytest.mark.parametrize("phase", [False, True])
def test_srnet_compact_f32_random_weights(rng, phase):
    feats, convs = 16, 2
    jm = jsrnet.SRNetCompact(features=feats, num_convs=convs, dtype=jnp.float32,
                             phase_output=phase)
    params = _random_flax_params(jm, rng)
    x = (rng.random((2, 12, 10, 3)) * 255).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _torch_model(params, feats, convs, torch.float32)
    got = tm(torch.from_numpy(x), phase_output=phase).numpy()
    assert got.shape == want.shape == ((2, 12, 10, 2, 2, 3) if phase else (2, 24, 20, 3))
    np.testing.assert_allclose(got, want, atol=ATOL_F32)


def test_tail_conv_phase_equals_full_res(rng):
    tail = tsrnet._TailConv(cin=3)
    with torch.no_grad():
        tail.weight.copy_(torch.from_numpy(rng.standard_normal((3, 3, 3, 3)).astype(np.float32)))
        tail.bias.copy_(torch.from_numpy(rng.standard_normal(3).astype(np.float32)))
    ph = torch.from_numpy(rng.standard_normal((1, 5, 6, 2, 2, 3)).astype(np.float32))
    with torch.no_grad():
        full = tail(interleave_phases(ph))
        via_phase = interleave_phases(tail.phase(ph))
    np.testing.assert_allclose(via_phase.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["srnet_compact", "srnet_student"])
def test_bf16_committed_weights(rng, name):
    feats, convs = META[name]
    jm = jsrnet.SRNetCompact(features=feats, num_convs=convs, phase_output=True)
    params = load_params(jm, str(REPO / "checkpoints" / name), jnp.zeros((1, 16, 16, 3)))
    x = (rng.random((2, 16, 16, 3)) * 255).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tio.load_srnet(tio.weights_path(name), device="cpu")
    assert (tm.features, tm.num_convs, tm.dtype) == (feats, convs, torch.bfloat16)
    got = tsrnet.srnet_phase_fn(tm)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want)
    max_tol, mean_tol = BF16_TOL[name]
    assert err.max() <= max_tol and err.mean() <= mean_tol, (err.max(), err.mean())
    # the same weights in float32 on both sides agree to the f32 tolerance
    want32 = np.asarray(jm.clone(dtype=jnp.float32).apply(params, jnp.asarray(x)))
    tm.dtype = torch.float32
    got32 = tsrnet.srnet_phase_fn(tm)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got32, want32, atol=ATOL_F32)


def test_srnet_large_and_adapters(rng):
    large = tsrnet.SRNetLarge()
    assert (large.features, large.num_convs) == (256, 8)
    jl = jsrnet.SRNetLarge()
    assert (jl.features, jl.num_convs) == (256, 8)
    m = tsrnet.SRNetCompact(features=8, num_convs=1).eval()
    up = tsrnet.srnet_upsample_fn(m)
    x = torch.from_numpy((rng.random((1, 6, 4, 3)) * 255).astype(np.float32))
    full = up(x)
    assert full.shape == (1, 12, 8, 3)
    np.testing.assert_allclose(interleave_phases(up.phase_fn(x)).numpy(), full.numpy(),
                               atol=1e-3)
