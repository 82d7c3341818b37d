"""The port's committed weights (SR nets, deblur net, inpaint net, LPIPS backbone,
saliency net, diffusion UNet) against the orbax checkpoints they were
exported from, and the port's import boundary.

Export (run once, from the repo root, where JAX and orbax are installed):

    python tests/test_torch_weights.py --write

writes ``elvis_tpu_torch/weights/<name>.npz`` for each name in ``EXPORTS``,
for ``srnet``, ``deblur``, ``inpaint``, ``perceptual``, ``saliency`` and
``diffusion``: the flax param tree as float32 arrays under their
``params/<layer>/<leaf>`` paths (``inpaint``: ``params/<layer>/Conv_0/<leaf>``
for its gated convs), plus the model's hyper-parameters (``features`` and
``num_convs``; for ``deblur``: ``features``, ``levels`` and the
``max_strength`` of ``checkpoints/deblur.meta.json``; for ``inpaint``:
``features`` and ``temporal_window``; for ``saliency`` and ``diffusion``:
``features``; ``perceptual`` has none: its widths are its kernels' shapes).
``srnet`` (RRDB ``SRNet``, 56 leaves, ~9.6 M parameters) stores every trunk
leaf as its bfloat16 bit pattern (uint16): the flax convs are
``dtype=bf16`` and cast kernel and bias to bf16 before use, so those bits
are exactly what both packages compute with, at half the bytes. Its two
``tail`` leaves stay float32, and its meta is ``features``, ``growth`` and
``num_blocks``.
One file alone: ``python tests/test_torch_weights.py --write <name>``.
"""

import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
# name -> (features, num_convs); the student's width/depth come from its
# checkpoints/srnet_student.meta.json, srnet_compact is the flax default,
# srnet_large is SRNetLarge()
EXPORTS = {"srnet_student": (256, 6), "srnet_compact": (128, 5), "srnet_large": (256, 8)}
# the shipped DeblurUNet is the flax default width and depth
DEBLUR = {"features": 32, "levels": 3}
# the shipped InpaintNet is the flax default width and window
INPAINT = {"features": 32, "temporal_window": 2}
# the shipped SaliencyNet and diffusion UNet are the flax default widths
SALIENCY = {"features": 24}
DIFFUSION = {"features": 32}
# RRDB SRNet: the flax default, the shape of checkpoints/srnet
RRDB = {"features": 128, "growth": 128, "num_blocks": 3}


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

    from elvis_tpu.models import DeblurUNet, SRNet, SRNetCompact
    from elvis_tpu.models.io import load_params

    if name == "srnet":  # the example args of restore.backends' load_tier
        return load_params(SRNet(**RRDB), str(REPO / "checkpoints" / name),
                           jnp.zeros((1, 16, 16, 3)))
    if name == "deblur":  # the example args of restore.backends.resolve_deblur_backend
        return load_params(DeblurUNet(**DEBLUR), str(REPO / "checkpoints" / name),
                           jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 2, 2), jnp.int32), 8)
    if name == "inpaint":  # the example args of restore.backends.resolve_inpaint_backend
        from elvis_tpu.models import InpaintNet

        return load_params(InpaintNet(**INPAINT), str(REPO / "checkpoints" / name),
                           jnp.zeros((2, 16, 16, 3)), jnp.zeros((2, 2, 2), jnp.int8), 8)
    if name == "perceptual":  # the example args of metrics.perceptual
        from elvis_tpu.metrics.perceptual import PerceptualNet

        return load_params(PerceptualNet(), str(REPO / "checkpoints" / name),
                           jnp.zeros((1, 64, 64, 3)))
    if name == "saliency":  # the example args of scoring.saliency
        from elvis_tpu.models import SaliencyNet

        return load_params(SaliencyNet(**SALIENCY), str(REPO / "checkpoints" / name),
                           np.zeros((2, 16, 16, 3), np.float32))
    if name == "diffusion":  # the abstract tree of restore.backends' 'diffusion'
        import jax
        import orbax.checkpoint as ocp

        from elvis_tpu.models import DiffusionRestorer
        from elvis_tpu.models.io import host_params

        d = DiffusionRestorer(**DIFFUSION)
        abstract = jax.eval_shape(lambda: d.init(jax.random.PRNGKey(0)))
        return host_params(ocp.StandardCheckpointer().restore(
            str(REPO / "checkpoints" / name), abstract))
    feats, convs = EXPORTS[name]
    model = SRNetCompact(features=feats, num_convs=convs)
    return load_params(model, str(REPO / "checkpoints" / name), jnp.zeros((1, 16, 16, 3)))


def deblur_max_strength():
    import json

    return float(json.loads((REPO / "checkpoints" / "deblur.meta.json").read_text())
                 ["max_strength"])


def bf16_bits(leaf):
    """float32 -> its round-to-nearest-even bfloat16 bit pattern (uint16),
    the cast flax's ``nn.Conv(dtype=bf16)`` makes."""
    import ml_dtypes

    return np.asarray(leaf, np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)


def rrdb_leaves(tree):
    """The RRDB export's leaves: trunk as bf16 bits, ``tail`` float32."""
    return {k: (v if k.startswith("params/tail/") else bf16_bits(v))
            for k, v in _flat(tree).items()}


def write_weights(name):
    if name == "srnet":
        out = REPO / "elvis_tpu_torch" / "weights" / "srnet.npz"
        np.savez_compressed(out, **{k: np.int64(v) for k, v in RRDB.items()},
                            **rrdb_leaves(orbax_params(name)))
        return out
    if name == "deblur":
        meta = {"features": np.int64(DEBLUR["features"]), "levels": np.int64(DEBLUR["levels"]),
                "max_strength": np.float64(deblur_max_strength())}
    elif name == "inpaint":
        meta = {k: np.int64(v) for k, v in INPAINT.items()}
    elif name == "perceptual":
        meta = {}
    elif name in ("saliency", "diffusion"):
        meta = {k: np.int64(v) for k, v in (SALIENCY if name == "saliency"
                                            else DIFFUSION).items()}
    else:
        feats, convs = EXPORTS[name]
        meta = {"features": np.int64(feats), "num_convs": np.int64(convs)}
    out = REPO / "elvis_tpu_torch" / "weights" / f"{name}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **meta, **_flat(orbax_params(name)))
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


def test_committed_deblur_weights_equal_orbax_restore():
    """Every array of the committed deblur.npz equals the orbax restore
    exactly, and its meta is the checkpoint's."""
    from elvis_tpu_torch.models.io import read_npz, weights_path

    path = weights_path("deblur")
    assert path is not None, "missing elvis_tpu_torch/weights/deblur.npz"
    tree, meta = read_npz(path)
    assert meta == {**DEBLUR, "max_strength": deblur_max_strength()}
    want = _flat(orbax_params("deblur"))
    got = _flat(tree)
    assert sorted(got) == sorted(want) and len(want) == 34  # 17 convs
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_committed_inpaint_weights_equal_orbax_restore():
    """Every array of the committed inpaint.npz equals the orbax restore
    exactly, leaf for leaf: five gated convs (nested ``Conv_0``) and two
    plain ones."""
    from elvis_tpu_torch.models.io import read_npz, weights_path

    path = weights_path("inpaint")
    assert path is not None, "missing elvis_tpu_torch/weights/inpaint.npz"
    tree, meta = read_npz(path)
    assert meta == INPAINT
    want = _flat(orbax_params("inpaint"))
    got = _flat(tree)
    assert sorted(got) == sorted(want) and len(want) == 16  # 8 convs
    assert "params/enc0/Conv_0/kernel" in got
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_load_inpaint_builds_the_shipped_net():
    import torch

    from elvis_tpu_torch.models.io import load_inpaint, weights_path

    net = load_inpaint(weights_path("inpaint"), device="cpu")
    assert (net.features, net.temporal_window) == (32, 2)
    assert net.dtype == torch.bfloat16 and not net.training
    assert not any(p.requires_grad for p in net.parameters())
    assert net.enc0.Conv_0.weight.shape == (64, 16, 3, 3)


def test_committed_perceptual_weights_equal_orbax_restore():
    """Every array of the committed perceptual.npz (the LPIPS backbone)
    equals the orbax restore exactly: five convs, no meta."""
    from elvis_tpu_torch.models.io import read_npz, weights_path

    path = weights_path("perceptual")
    assert path is not None, "missing elvis_tpu_torch/weights/perceptual.npz"
    tree, meta = read_npz(path)
    assert meta == {}
    want = _flat(orbax_params("perceptual"))
    got = _flat(tree)
    assert sorted(got) == sorted(want) and len(want) == 10  # 5 convs
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_load_perceptual_builds_the_shipped_net():
    from elvis_tpu_torch.metrics.perceptual import ensure_loaded

    net = ensure_loaded("cpu")
    assert net.features == (32, 64, 128, 128, 128) and not net.training
    assert not any(p.requires_grad for p in net.parameters())


def test_load_deblur_builds_the_shipped_net():
    import torch

    from elvis_tpu_torch.models.io import load_deblur, weights_path

    net = load_deblur(weights_path("deblur"), device="cpu")
    assert (net.features, net.levels, net.max_strength) == (32, 3, deblur_max_strength())
    assert net.dtype == torch.bfloat16 and not net.training
    assert not any(p.requires_grad for p in net.parameters())


@pytest.mark.parametrize("name,meta,leaves", [("saliency", SALIENCY, 14),  # 7 convs
                                               ("diffusion", DIFFUSION, 16)])  # 7 convs + dense
def test_committed_saliency_and_diffusion_weights_equal_orbax_restore(name, meta, leaves):
    """Every array of the committed saliency.npz / diffusion.npz equals the
    orbax restore exactly, leaf for leaf, and its meta is the model's width."""
    from elvis_tpu_torch.models.io import read_npz, weights_path

    path = weights_path(name)
    assert path is not None, f"missing elvis_tpu_torch/weights/{name}.npz"
    tree, got_meta = read_npz(path)
    assert got_meta == meta
    want = _flat(orbax_params(name))
    got = _flat(tree)
    assert sorted(got) == sorted(want) and len(want) == leaves
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}:{key}")


def test_load_saliency_and_diffusion_build_the_shipped_nets():
    import torch

    from elvis_tpu_torch.models.io import load_diffusion, load_saliency, weights_path

    sal = load_saliency(weights_path("saliency"), device="cpu")
    assert sal.features == 24 and sal.dtype == torch.bfloat16 and not sal.training
    assert sal.down1.weight.shape == (96, 48, 3, 3) and sal.head.weight.shape == (1, 48, 3, 3)
    diff = load_diffusion(weights_path("diffusion"), device="cpu")
    assert diff.unet.features == 32 and not diff.training
    assert diff.unet.Dense_0.weight.shape == (64, 32)
    assert getattr(diff.unet, "in").weight.shape == (32, 6, 3, 3)
    assert float(diff.unet.eps.weight.abs().max()) > 0  # trained: not the zero init
    for net in (sal, diff):
        assert not any(p.requires_grad for p in net.parameters())


def test_committed_rrdb_weights_are_the_bf16_restore():
    """weights/srnet.npz: each trunk leaf bit for bit the orbax restore cast
    to bf16 (uint16 in the file), each ``tail`` leaf the float32 restore
    exactly; 56 leaves, the RRDB meta, at most ~20 MB on disk."""
    from elvis_tpu_torch.models.io import read_npz, weights_path

    path = weights_path("srnet")
    assert path is not None, "missing elvis_tpu_torch/weights/srnet.npz"
    assert os.path.getsize(path) <= 20_500_000
    want = _flat(orbax_params("srnet"))
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files if "/" in k}
        assert {k: data[k].item() for k in data.files if "/" not in k} == RRDB
    assert sorted(stored) == sorted(want) and len(want) == 56
    tail = [k for k in want if k.startswith("params/tail/")]
    assert sorted(tail) == ["params/tail/bias", "params/tail/kernel"]
    for key in want:
        if key in tail:
            assert stored[key].dtype == np.float32
            np.testing.assert_array_equal(stored[key], want[key], err_msg=key)
        else:
            assert stored[key].dtype == np.uint16
            np.testing.assert_array_equal(stored[key], bf16_bits(want[key]), err_msg=key)
    tree, _ = read_npz(path)  # read back as the bf16 values in float32
    got = _flat(tree)
    import ml_dtypes

    k = "params/rrdb2/db1/fuse/kernel"
    np.testing.assert_array_equal(got[k], want[k].astype(ml_dtypes.bfloat16).astype(np.float32))


def test_load_srnet_builds_rrdb_from_num_blocks():
    import torch

    from elvis_tpu_torch.models.io import load_srnet, weights_path
    from elvis_tpu_torch.models.srnet import SRNet

    net = load_srnet(weights_path("srnet"), device="cpu")
    assert isinstance(net, SRNet) and net.dtype == torch.bfloat16 and not net.training
    assert (net.features, net.growth, net.num_blocks) == (128, 128, 3)
    assert net.rrdb2.db1.fuse.weight.shape == (128, 512, 3, 3)
    assert net.up.weight.shape == (512, 128, 3, 3) and net.tail.weight.shape == (3, 128, 3, 3)
    assert sum(p.numel() for p in net.parameters()) == 9_595_395


def test_load_srnet_builds_the_large_tier():
    from elvis_tpu_torch.models.io import load_srnet, weights_path

    net = load_srnet(weights_path("srnet_large"), device="cpu")
    assert (net.features, net.num_convs) == (256, 8)
    assert net.conv7.weight.shape == (256, 256, 3, 3)


def test_params_from_flax_transposes_dense_kernels():
    """A dense kernel ``(in, out)`` becomes a Linear weight ``(out, in)``."""
    from elvis_tpu_torch.models.io import params_from_flax

    rng = np.random.default_rng(2)
    k = rng.standard_normal((4, 7)).astype(np.float32)
    bias = rng.standard_normal((7,)).astype(np.float32)
    sd = params_from_flax({"params": {"Dense_0": {"kernel": k, "bias": bias}}})
    np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(), k.T)
    with pytest.raises(ValueError, match="dense kernel"):
        params_from_flax({"params": {"x": {"kernel": k[0], "bias": bias}}})


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


def test_params_from_flax_descends_into_nested_layers():
    """A layer that holds a sub-layer (a gated conv's ``Conv_0``) becomes a
    dotted state_dict name."""
    from elvis_tpu_torch.models.io import params_from_flax

    rng = np.random.default_rng(1)
    k = rng.standard_normal((3, 3, 2, 6)).astype(np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32)
    sd = params_from_flax({"params": {"enc0": {"Conv_0": {"kernel": k, "bias": bias}},
                                      "up": {"kernel": k, "bias": bias}}})
    assert sorted(sd) == ["enc0.Conv_0.bias", "enc0.Conv_0.weight", "up.bias", "up.weight"]
    np.testing.assert_array_equal(sd["enc0.Conv_0.weight"].numpy(), k.transpose(3, 2, 0, 1))


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
    and neither do chip_smoke.py and the card's test files."""
    banned = ("jax", "jaxlib", "flax", "orbax", "optax", "elvis_tpu")
    files = sorted((REPO / "elvis_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py",
        REPO / "tests" / "_steps_apart.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in banned
    ]
    assert not bad, bad


ALL = (*EXPORTS, "srnet", "deblur", "inpaint", "perceptual", "saliency", "diffusion")

if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"] or not set(sys.argv[2:]) <= set(ALL):
        sys.exit(f"usage: python tests/test_torch_weights.py --write [{' | '.join(ALL)} ...]")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    for n in sys.argv[2:] or ALL:
        print(write_weights(n))
