"""Port parity: the generic names of ``models.io`` and ``utils.transfer.pull``.

The port reads ``.npz`` weights files where the JAX package restores orbax
directories (the card's machine has no orbax), so ``load_params`` is held
to the shipped ``srnet_student.npz`` read through ``read_npz`` and to
``load_srnet``, bit for bit. ``maybe_load_params`` with no file gives a
fresh net, which in both packages returns its classical Lanczos base (the
zero tail): exactly, in each package, and within 1e-3 of each other (the
two packages' Lanczos bases, the resize tests' tolerance). ``pull`` keeps
dtype and bits, as JAX's ``pull`` does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.models import io as jio
from elvis_tpu.models.srnet import SRNetCompact as JSRNetCompact
from elvis_tpu.ops.resize import resize as jresize
from elvis_tpu.utils import transfer as jtransfer
from elvis_tpu_torch.models import SRNetCompact, io as tio
from elvis_tpu_torch.ops.resize import resize
from elvis_tpu_torch.utils import pull


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_maybe_load_params_without_a_file_is_the_lanczos_base_in_both_packages(tmp_path):
    missing = str(tmp_path / "missing")
    x = (np.random.default_rng(1).random((2, 16, 16, 3)) * 255).astype(np.float32)

    jmodel = JSRNetCompact(features=8, num_convs=2)
    jparams = jio.maybe_load_params(jmodel, missing, jnp.zeros((1, 16, 16, 3)))
    jy = np.asarray(jmodel.apply(jparams, jnp.asarray(x)))
    np.testing.assert_array_equal(jy, np.asarray(jnp.clip(jresize(jnp.asarray(x), (32, 32),
                                                                  method="lanczos4"), 0, 255)))

    model = tio.maybe_load_params(SRNetCompact(features=8, num_convs=2), missing + ".npz")
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    base = torch.clamp(resize(torch.from_numpy(x), (32, 32), method="lanczos4"), 0, 255)
    assert torch.equal(y, base)
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-3)


def test_init_params_draws_from_its_generator_and_leaves_the_module():
    model = SRNetCompact(features=8, num_convs=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = tio.init_params(model)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    again = tio.init_params(model, torch.Generator().manual_seed(0))
    assert fresh.keys() == before.keys()
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)
    for name, v in fresh.items():
        if name.endswith("bias") or name.startswith("tail."):
            assert not v.any(), name
        else:  # LeCun normal: std 1/sqrt(fan_in)
            assert abs(float(v.std()) * v[0].numel() ** 0.5 - 1) < 0.2, name


def test_load_params_and_host_params_round_trip_the_shipped_student(tmp_path):
    path = tio.weights_path("srnet_student")
    tree, meta = tio.read_npz(path)
    model = tio.load_params(SRNetCompact(int(meta["features"]), int(meta["num_convs"])), path)
    host = tio.host_params(model)
    want = {k: v.numpy() for k, v in tio.params_from_flax(tree).items()}
    assert host.keys() == want.keys()
    for k in want:
        assert host[k].dtype == np.float32 and np.array_equal(host[k], want[k]), k
    loaded = tio.host_params(tio.load_srnet(path, device="cpu").state_dict())
    assert all(np.array_equal(loaded[k], host[k]) for k in host)
    # written back through write_npz and read again: the same arrays
    again = tmp_path / "student.npz"
    tio.write_npz(str(again), model.state_dict(), meta)
    model2 = tio.maybe_load_params(SRNetCompact(int(meta["features"]), int(meta["num_convs"])),
                                   str(again))
    assert all(np.array_equal(v, host[k]) for k, v in tio.host_params(model2).items())
    assert tio.default_checkpoint_dir() == tio.weights_dir()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int16, torch.uint8,
                                   torch.int32, torch.bool])
def test_pull_keeps_dtype_and_bits(rng, dtype):
    x = torch.from_numpy((rng.standard_normal((5, 3, 4)) * 300).astype(np.float64)).to(dtype)
    if dtype.is_floating_point:  # signed zero, infinities, a NaN
        x.view(-1)[:4] = torch.tensor([-0.0, float("inf"), -float("inf"), float("nan")])
    got = pull(x)
    assert isinstance(got, np.ndarray) and got.shape == tuple(x.shape)
    assert got.dtype == x.numpy().dtype
    assert got.tobytes() == x.numpy().tobytes()
    assert pull(got).tobytes() == got.tobytes()  # numpy arrays pass through
    if dtype != torch.float64:  # JAX runs without 64-bit types
        want = jtransfer.pull(jnp.asarray(got))
        assert want.dtype == got.dtype and want.tobytes() == got.tobytes()
