"""Port parity: the PDE fill of the removal branch (``restore.inpaint``),
its backend resolver, and the temporal blend (``restore.temporal``)
against ``elvis_tpu``.

Tolerances: the fill runs the reference's exact stencil (4-neighbour mean
with edge rows/columns replicated, known pixels pinned, 200 iterations
from the mean of the known pixels); only that starting mean is a float32
sum in another order, so float32 frames agree within 1e-3 and uint8 frames
within 1 LSB. The temporal blend agrees within 1e-4 in float32 and 1 LSB
in uint8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.restore import inpaint as jinp
from elvis_tpu.restore import temporal as jtmp
from elvis_tpu.restore.backends import resolve_inpaint_backend as jresolve
from elvis_tpu_torch.pipeline.config import ElvisConfig
from elvis_tpu_torch.restore import inpaint as tinp
from elvis_tpu_torch.restore import temporal as ttmp
from elvis_tpu_torch.restore.backends import resolve_inpaint_backend as tresolve
from elvis_tpu_torch.restore.registry import get_restorer

F32_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stretched(dtype, n=3, by=5, bx=8, b=8, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:by * b, 0:bx * b]
    base = 120 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    frames = np.clip(base[None, ..., None] + rng.normal(0, 8, (n, by * b, bx * b, 3)), 0, 255)
    mask = (rng.random((n, by, bx)) < 0.3).astype(np.int8)
    mask[0, :, :2] = 1  # holes on the frame edge
    mask[1, 0, :] = 1   # a whole block row
    hole = np.repeat(np.repeat(mask, b, 1), b, 2)[..., None].astype(bool)
    frames = np.where(hole, 0, frames)  # holes black, as the stretch leaves them
    return frames.astype(dtype), mask


@pytest.mark.parametrize("iters", [1, 7, 200])
def test_masked_jacobi_float32(iters):
    frames, mask = _stretched(np.float32)
    hole = np.repeat(np.repeat(mask, 8, 1), 8, 2)[..., None].astype(bool)
    j = jax.jit(lambda f, h: jinp._masked_jacobi(f, h, iters))(jnp.asarray(frames),
                                                               jnp.asarray(hole))
    t = tinp._masked_jacobi(torch.from_numpy(frames), torch.from_numpy(hole), iters)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=F32_ATOL, rtol=0)
    known = ~hole[..., 0]
    assert np.array_equal(_np(t)[known], frames[known])  # known pixels pinned


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_restore_removal_diffusion(dtype):
    frames, mask = _stretched(dtype, seed=1)
    j = np.asarray(jax.jit(lambda f, m: jinp.restore_removal_diffusion(f, m, 8))(
        jnp.asarray(frames), jnp.asarray(mask)))
    t = _np(tinp.restore_removal_diffusion(torch.from_numpy(frames), torch.from_numpy(mask), 8))
    assert t.dtype == j.dtype == dtype
    if dtype == np.uint8:
        assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)


def test_inpaint_backend_resolves_diffusion_only():
    """'diffusion' resolves to the registered PDE fill; the windowed names
    resolve too now, with the JAX package's provenance (the net's weights
    file in place of its orbax directory); other names raise."""
    from elvis_tpu.pipeline.config import ElvisConfig as JConfig

    cfg = ElvisConfig(inpaint_backends=["diffusion"])
    fn, prov = tresolve("diffusion", cfg, device="cpu")
    assert prov == jresolve("diffusion", JConfig())[1] == "pde_diffusion"
    assert fn is tinp.restore_removal_diffusion is get_restorer("removal", "diffusion")
    assert get_restorer("removal", "temporal") is tinp.restore_removal_temporal
    for name in ("temporal", "neural", "inpaint_net", "e2fgvi"):
        t_fn, t_prov = tresolve(name, cfg, device="cpu")
        j_fn, j_prov = jresolve(name, JConfig())
        assert t_prov.split("[")[1:] == j_prov.split("[")[1:], name
        assert t_fn.temporal_overlap == j_fn.temporal_overlap, name
    with pytest.raises(ValueError, match="unknown inpaint backend"):
        tresolve("telea", cfg, device="cpu")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("blend", [0.0, 0.1, 0.5])
def test_temporal_blend(dtype, blend):
    rng = np.random.default_rng(2)
    frames = (rng.random((6, 8, 12, 3)) * 255).astype(dtype)
    j = np.asarray(jax.jit(lambda f: jtmp.temporal_blend(f, blend))(jnp.asarray(frames)))
    t = _np(ttmp.temporal_blend(torch.from_numpy(frames), blend))
    assert t.dtype == j.dtype
    if dtype == np.uint8:
        assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
