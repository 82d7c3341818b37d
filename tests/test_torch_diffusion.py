"""Port parity: the diffusion restorer (``elvis_tpu_torch.models.diffusion``),
``naive_diffusion_restore`` and the OOM-only ``safe_restore`` against
``elvis_tpu.models.diffusion`` / ``elvis_tpu.restore.level_seq``, with the
shipped weights (``weights/diffusion.npz`` against ``checkpoints/diffusion``),
on the same numpy inputs, on the CPU.

The SDEdit noise is the very array JAX draws,
``jax.random.normal(PRNGKey(seed), cond.shape)``, handed to the port.

Tolerances (grey levels unless said otherwise):
  * the UNet's residual in float32 within 1e-5 (measured 3.9e-7), in bf16
    within 0.005 (measured 0.0019 on residuals up to 0.64);
  * the time embedding within 4e-6 (sin and cos of angles up to 999 rad;
    measured 1.9e-6);
  * the integer schedule exactly, for every step count from 1 to 20 and
    for 24, 30 and 40;
  * the trajectory, ``sample`` and ``restore_adaptive`` in float32 within
    0.01 (measured 8e-5); in bf16 max 1.0 and mean 0.1 (measured 0.46 and
    0.063), against a mean change of the input of 14-24 grey levels;
  * ``naive_diffusion_restore`` returns its input: uint8 bit for bit, float32
    within 4e-5 in both packages (the sampler maps x to
    ``(x / 127.5 - 1 + 1) * 127.5``).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.models import DiffusionRestorer as JDiffusion
from elvis_tpu.models.diffusion import _CondUNet as JUNet
from elvis_tpu.models.diffusion import _time_embedding as jembed
from elvis_tpu_torch.models.diffusion import _time_embedding as tembed
from elvis_tpu_torch.models.diffusion import ddim_timesteps

BF16_MAX, BF16_MEAN = 1.0, 0.1
F32_MAX = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def restorers():
    """(JAX restorer, its params, port restorer) on the shipped weights."""
    import orbax.checkpoint as ocp

    from elvis_tpu.models.io import default_checkpoint_dir, host_params
    from elvis_tpu_torch.models.io import load_diffusion, weights_path

    jd = JDiffusion()
    abstract = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0)))
    path = os.path.abspath(os.path.join(default_checkpoint_dir(), "diffusion"))
    jp = host_params(ocp.StandardCheckpointer().restore(path, abstract))
    return jd, jp, load_diffusion(weights_path("diffusion"), device="cpu")


@pytest.fixture(scope="module")
def clip():
    """4 frames of 32x48: smooth content (a bilinear upscale of noise) and a
    per-block strength map 0..3."""
    rng = np.random.default_rng(1)
    small = rng.integers(0, 256, (4, 8, 12, 3)).astype(np.float32)
    frames = jax.image.resize(jnp.asarray(small), (4, 32, 48, 3), "linear")
    frames = np.round(np.asarray(frames)).astype(np.uint8)
    return frames, rng.integers(0, 4, (4, 4, 6)).astype(np.int32)


def _jax_noise(shape, seed=42):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _set_dtype(td, dtype):
    td.unet.dtype = dtype
    return td


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 0.005)])
def test_cond_unet_matches_jax(restorers, dtype, atol):
    _, jp, td = restorers
    rng = np.random.default_rng(0)
    x, c = (rng.uniform(-1, 1, (3, 32, 48, 3)).astype(np.float32) for _ in range(2))
    t = np.array([399, 200, 5], np.int32)
    want = np.asarray(JUNet(dtype=getattr(jnp, dtype)).apply(
        jp, jnp.asarray(x), jnp.asarray(c), jembed(jnp.asarray(t))))
    with torch.inference_mode():
        got = _set_dtype(td, getattr(torch, dtype)).unet(
            torch.from_numpy(x), torch.from_numpy(c), tembed(torch.from_numpy(t)))
    _set_dtype(td, torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert np.abs(want).max() > 0.1  # the trained head is not the zero init


def test_time_embedding_matches_jax():
    t = np.arange(0, 1000, 7).astype(np.int32)
    got = tembed(torch.from_numpy(t))
    assert got.shape == (len(t), 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jembed(jnp.asarray(t))), rtol=0,
                               atol=4e-6)


@pytest.mark.parametrize("t_start", [0.4, 0.25, 0.7])
def test_integer_schedule_equals_jax(t_start):
    """``jnp.linspace(t0, 1, steps).astype(int32)`` for the step counts the
    pipeline uses (2 * gaussian_max_rounds: 20 by default, up to 40 at 20
    rounds; naive_diffusion's 4) and the tests use (6, 8), and every count
    between. ``torch.linspace`` moves a timestep by one at some counts."""
    t0 = int(t_start * 999)
    for steps in [*range(1, 21), 24, 30, 40]:
        want = np.asarray(jnp.linspace(t0, 1, steps).astype(jnp.int32)).tolist()
        assert ddim_timesteps(t0, steps) == want, steps
    assert ddim_timesteps(399, 20) == [399, 378, 357, 336, 315, 294, 273, 252, 231, 210, 189,
                                       168, 147, 126, 105, 84, 63, 42, 21, 1]


def _close(got, want, f32, what):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if f32:
        assert d.max() <= F32_MAX, (what, d.max())
    else:
        assert d.max() <= BF16_MAX and d.mean() <= BF16_MEAN, (what, d.max(), d.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_x0_path_matches_jax(restorers, clip, dtype):
    jd, jp, td = restorers
    frames, _ = clip
    if dtype == "float32":
        jd = JDiffusion()
        jd.unet = JUNet(dtype=jnp.float32)
    cond = frames.astype(np.float32) / 127.5 - 1.0
    want = np.asarray(jd._x0_path(jp, jnp.asarray(cond), 8, 0.4, jax.random.PRNGKey(42)))
    with torch.inference_mode():
        got = torch.stack(list(_set_dtype(td, getattr(torch, dtype))._x0_path(
            torch.from_numpy(cond), 8, 0.4, torch.from_numpy(_jax_noise(cond.shape)))))
    _set_dtype(td, torch.bfloat16)
    assert got.shape == want.shape == (8,) + cond.shape
    _close(got.numpy() * 127.5, want * 127.5, dtype == "float32", "x0 path")
    assert np.abs(want[-1] - cond).mean() * 127.5 > 10  # the net restores


def test_sample_and_restore_adaptive_match_jax(restorers, clip):
    jd, jp, td = restorers
    frames, smap = clip
    noise = torch.from_numpy(_jax_noise(frames.shape))
    want = np.asarray(jd.sample(jp, jnp.asarray(frames), steps=8, rng=jax.random.PRNGKey(42)))
    got = td.sample(torch.from_numpy(frames), steps=8, noise=noise)
    assert got.dtype == torch.float32
    _close(got, want, False, "sample")
    want = np.asarray(jd.restore_adaptive(jp, jnp.asarray(frames), jnp.asarray(smap), 8,
                                          max_rounds=3, rng=jax.random.PRNGKey(42)))
    got = td.restore_adaptive(torch.from_numpy(frames), torch.from_numpy(smap), 8,
                              max_rounds=3, noise=noise).numpy()
    _close(got, want, False, "restore_adaptive")
    # strength-0 blocks keep the input, the others moved
    keep = np.repeat(np.repeat(smap == 0, 8, 1), 8, 2)
    np.testing.assert_allclose(got[keep], frames[keep], atol=1e-4)
    assert np.abs(got[~keep] - frames[~keep]).mean() > 5


def test_sample_with_a_perturbed_head_matches_jax(clip):
    """The untrained restorer with a nonzero head (seeded noise on the
    ``eps`` kernel and bias): the sampler is held while it is not the
    identity."""
    from elvis_tpu_torch.models.diffusion import DiffusionRestorer
    from elvis_tpu_torch.models.io import params_from_flax

    frames, _ = clip
    jd = JDiffusion()
    jp = jax.tree_util.tree_map(np.array, jd.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    eps = jp["params"]["eps"]
    eps["kernel"] = (0.05 * rng.standard_normal(eps["kernel"].shape)).astype(np.float32)
    eps["bias"] = (0.05 * rng.standard_normal(eps["bias"].shape)).astype(np.float32)
    td = DiffusionRestorer()
    td.unet.load_state_dict(params_from_flax(jp))
    want = np.asarray(jd.sample(jp, jnp.asarray(frames), steps=6, rng=jax.random.PRNGKey(7)))
    got = td.sample(torch.from_numpy(frames), steps=6,
                    noise=torch.from_numpy(_jax_noise(frames.shape, 7))).numpy()
    _close(got, want, False, "sample, perturbed head")
    assert np.abs(want - frames).mean() > 5


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_naive_diffusion_returns_its_input_in_both_packages(clip, dtype):
    """The untrained head is zero, so every x0 prediction is the clipped
    conditioning: the restore is the identity whatever the other weights."""
    from elvis_tpu.restore.level_seq import naive_diffusion_restore as jnaive
    from elvis_tpu_torch.restore.level_seq import naive_diffusion_restore as tnaive

    frames, smap = clip
    frames = frames.astype(dtype)
    want = np.asarray(jnaive(jnp.asarray(frames), jnp.asarray(smap), 8))
    got = tnaive(torch.from_numpy(frames), torch.from_numpy(smap), 8)
    assert got.dtype == torch.from_numpy(frames).dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(want, frames)
        np.testing.assert_array_equal(got.numpy(), frames)
    else:
        np.testing.assert_allclose(want, frames, rtol=0, atol=4e-5)
        np.testing.assert_allclose(got.numpy(), frames, rtol=0, atol=4e-5)


def test_safe_restore_catches_only_out_of_memory(clip):
    """Out of device memory: a warning and the input back. Any other error
    raises: a restorer that failed must not pass for one that returned its
    input (the JAX package catches every exception)."""
    from elvis_tpu_torch.restore import level_seq
    from elvis_tpu_torch.restore.registry import RestoreFallbackWarning, safe_restore

    frames = torch.from_numpy(clip[0])

    def oom(f):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    def broken(f):
        raise RuntimeError("a bug")

    with pytest.warns(RestoreFallbackWarning, match="out of device memory"):
        out, err = safe_restore(oom, frames)
    assert out is frames and err.startswith("OutOfMemoryError")
    with pytest.raises(RuntimeError, match="a bug"):
        safe_restore(broken, frames)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, err = safe_restore(lambda f: f + 1, frames)
    assert err is None and torch.equal(out, frames + 1)

    class Broken:
        def sample(self, f, steps):
            raise RuntimeError("a bug")

    with pytest.raises(RuntimeError, match="a bug"):
        level_seq.naive_diffusion_restore(frames, torch.from_numpy(clip[1]), 8, model=Broken())
