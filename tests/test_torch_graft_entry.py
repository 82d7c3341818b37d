"""Port parity: ``elvis_tpu_torch.graft_entry`` (``entry`` and
``dryrun_multichip``) against the repository's ``__graft_entry__.py``, and
``core.blocks.downsample_mask`` against ``elvis_tpu.core.blocks``.

``entry()``'s forward at JAX's ``entry()`` weights (carried across by
``models.io.params_from_flax``; the zero tail given the same random values
in both, so the trunk shows) on the same input: within 2.3 grey levels
max and 0.23 mean, the bf16 tolerance of RRDB ``SRNet`` at flax-initialised
weights in tests/test_torch_srnet_rrdb.py (the trunk in bf16 in both
packages, which round their convolutions differently; measured 1.13 /
0.157). ``dryrun_multichip(2)`` on two logical CPU
shards runs its four parts, each held to its unsharded run inside (sharded
SR and the halo fill within 1e-3, the tiled restore within 0.1 grey
level); the readings are checked here. ``downsample_mask``: equal.
"""

import numpy as np
import pytest
import torch

from elvis_tpu_torch.models.io import params_from_flax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_entry_forward_equals_jax_entry_at_its_weights():
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as jentry
    from elvis_tpu_torch.graft_entry import entry

    jfn, (jparams, jx) = jentry.entry()
    fn, (params, x) = entry(device="cpu")
    assert x.shape == tuple(jx.shape) and x.dtype == torch.float32
    assert set(params) == set(params_from_flax(jax.tree.map(np.asarray, jparams)))
    assert torch.equal(fn(params, x), torch.zeros((2, 256, 256, 3)))  # zero tail, zero input
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(4)
    tail = tree["params"]["tail"]
    tail["kernel"] = (0.05 * rng.standard_normal(tail["kernel"].shape)).astype(np.float32)
    xin = (rng.random((2, 32, 32, 3)) * 255).astype(np.float32)
    want = np.asarray(jfn(tree, jnp.asarray(xin)))
    got = fn(params_from_flax(tree), torch.from_numpy(xin)).numpy()
    d = np.abs(got - want)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert d.max() <= 2.3 and d.mean() <= 0.23, (d.max(), d.mean())


def test_dryrun_multichip_on_two_logical_shards():
    from elvis_tpu_torch.graft_entry import dryrun_multichip
    from elvis_tpu_torch.parallel import mesh as pmesh

    real = pmesh.devices
    out = dryrun_multichip(2, device="cpu")
    assert pmesh.devices is real  # the logical shards end with the dry run
    assert out["logical"] and out["mesh"] == {"data": 1, "tensor": 2}
    assert out["mesh2d"] == {"data": 1, "spatial": 2}
    assert np.isfinite(out["loss"])
    assert out["sr_max_err"] < 1e-3 and out["halo_fill_max_err"] < 1e-3
    assert out["tiled_max_err"] < 0.1
    assert set(out["fg_psnr"]) == {"Baseline", "PRESLEY RealESRGAN", "ELVIS ProPainter"}


@pytest.mark.parametrize("threshold", [0.5, 0.2])
def test_downsample_mask_equals_jax(threshold):
    import jax.numpy as jnp

    from elvis_tpu.core.blocks import downsample_mask as jdown
    from elvis_tpu_torch.core.blocks import downsample_mask

    rng = np.random.default_rng(int(threshold * 10))
    mask = rng.random((3, 2, 24, 40)) < 0.4
    mask[0, 0, :8, :8] = True  # a full block, and one exactly at half
    mask[0, 0, :8, 8:16] = np.arange(8)[None, :] < 4
    want = np.asarray(jdown(jnp.asarray(mask), 8, threshold))
    for m in (mask, mask.astype(np.uint8), mask.astype(np.float32)):
        got = downsample_mask(torch.from_numpy(m), 8, threshold)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
