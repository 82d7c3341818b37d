"""The port's committed SR weights against the orbax checkpoints they were
exported from, and the port's import boundary.

Export (run once, from the repo root, where JAX and orbax are installed):

    python tests/test_torch_weights.py --write

writes ``elvis_tpu_torch/weights/<name>.npz`` for each name in ``EXPORTS``:
the flax param tree as float32 arrays under their ``params/<layer>/<leaf>``
paths, plus the model's ``features`` and ``num_convs``.
"""

import ast
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# name -> (features, num_convs); the student's width/depth come from its
# checkpoints/srnet_student.meta.json, srnet_compact is the flax default
EXPORTS = {"srnet_student": (256, 6), "srnet_compact": (128, 5)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def orbax_params(name):
    """The flax param tree of ``checkpoints/<name>`` as host numpy arrays."""
    import jax.numpy as jnp

    from elvis_tpu.models import SRNetCompact
    from elvis_tpu.models.io import load_params

    feats, convs = EXPORTS[name]
    model = SRNetCompact(features=feats, num_convs=convs)
    return load_params(model, str(REPO / "checkpoints" / name), jnp.zeros((1, 16, 16, 3)))


def write_weights(name):
    feats, convs = EXPORTS[name]
    out = REPO / "elvis_tpu_torch" / "weights" / f"{name}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, features=np.int64(feats), num_convs=np.int64(convs),
                        **_flat(orbax_params(name)))
    return out


def test_student_meta_matches_export_shape():
    import json

    meta = json.loads((REPO / "checkpoints" / "srnet_student.meta.json").read_text())
    assert (meta["features"], meta["num_convs"]) == EXPORTS["srnet_student"]


def test_committed_weights_equal_orbax_restore():
    """Every array of each committed .npz equals the orbax restore exactly."""
    from elvis_tpu_torch.models.io import read_npz, weights_path

    for name, (feats, convs) in EXPORTS.items():
        path = weights_path(name)
        assert path is not None, f"missing elvis_tpu_torch/weights/{name}.npz"
        tree, meta = read_npz(path)
        assert (meta["features"], meta["num_convs"]) == (feats, convs)
        want = _flat(orbax_params(name))
        got = _flat(tree)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}:{key}")


def test_params_from_flax_layout():
    """HWIO kernels become OIHW conv weights under the flax layer names."""
    from elvis_tpu_torch.models.io import params_from_flax

    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    bias = rng.standard_normal((5,)).astype(np.float32)
    sd = params_from_flax({"params": {"conv0": {"kernel": k, "bias": bias}}})
    assert sorted(sd) == ["conv0.bias", "conv0.weight"]
    np.testing.assert_array_equal(sd["conv0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["conv0.bias"].numpy(), bias)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    """No module of elvis_tpu_torch imports jax, flax, orbax or elvis_tpu,
    and chip_smoke.py neither."""
    banned = ("jax", "jaxlib", "flax", "orbax", "optax", "elvis_tpu")
    files = sorted((REPO / "elvis_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in banned
    ]
    assert not bad, bad


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_weights.py --write")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    for n in EXPORTS:
        print(write_weights(n))
