"""Port parity: ``elvis_tpu_torch.pipeline.config`` against
``elvis_tpu.pipeline.config``, and the port's own field audit.

The config dict is held EQUAL to the JAX package's (it feeds the stage
cache's key and ``parameters.config`` of the results JSON), field for
field and in order; the merge order defaults -> --config JSON -> flags
gives equal configs from the same argv. Every field of the port is live
(a call site in ``elvis_tpu_torch/``), absorbed, or pending with the
ROADMAP item that brings it; each pending field and each backend name not
ported yet makes ``run_elvis`` raise before stage 0.
"""

import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from elvis_tpu.pipeline import config as jcfg
from elvis_tpu_torch.pipeline import config as tcfg

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_fields_names_defaults_and_order_equal_jax():
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jcfg.ElvisConfig)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(tcfg.ElvisConfig)]
    assert tf == jf and len(tf) == 90
    assert list(tcfg.ElvisConfig().to_dict().items()) == list(jcfg.ElvisConfig().to_dict().items())


@pytest.mark.parametrize("data", [
    {"width": 64, "height": 48, "inpaint_backends": ["diffusion"]},
    {"width": 64, "bogus_key": 1},
    {"sr_backends": ["srnet_compact", "progressive_lanczos"], "target_bitrate_override": 1000},
])
def test_config_from_dict_equals_jax(data, capsys):
    t = tcfg.config_from_dict(dict(data))
    t_out = capsys.readouterr().out
    j = jcfg.config_from_dict(dict(data))
    assert t.to_dict() == j.to_dict()
    assert t_out == capsys.readouterr().out  # the same warning, or none
    if "bogus_key" in data:
        for mod in (tcfg, jcfg):
            with pytest.raises(TypeError):
                mod.config_from_dict(dict(data), strict=True)


@pytest.mark.parametrize("argv", [
    [],
    ["--width", "256", "--enable_fvmd", "false", "--shrink_amount", "0.5"],
    ["--inpaint_backends", '["diffusion"]', "--max_frames", "4", "--verbose", "0"],
    ["--config", "{cfg}", "--width", "256"],
])
def test_cli_merge_order_equals_jax(argv, tmp_path):
    cfg_file = tmp_path / "c.json"
    cfg_file.write_text(json.dumps({"width": 320, "height": 240, "block_size": 16,
                                    "deblur_backends": ["unsharp"]}))
    argv = [a.replace("{cfg}", str(cfg_file)) for a in argv]
    t = tcfg.load_config_from_cli(list(argv))
    assert t.to_dict() == jcfg.load_config_from_cli(list(argv)).to_dict()
    if "--config" in argv:
        assert (t.width, t.height, t.block_size) == (256, 240, 16)  # flag > file > default


def _port_source_without_config():
    chunks = []
    for path in sorted((REPO / "elvis_tpu_torch").rglob("*.py")):
        if path.parts[-2:] != ("pipeline", "config.py"):
            chunks.append(path.read_text())
    return "\n".join(chunks)


def test_every_field_live_absorbed_or_pending():
    src = _port_source_without_config()
    names = [f.name for f in dataclasses.fields(tcfg.ElvisConfig)]
    absorbed, pending = tcfg.ABSORBED_FIELDS, set(tcfg.PENDING_FIELDS)
    assert not absorbed & pending
    assert absorbed | pending <= set(names)
    assert jcfg.ABSORBED_FIELDS <= absorbed  # absorbed there: absorbed here
    missing = [n for n in names if n not in absorbed | pending
               and not re.search(rf"(\.{n}\b|[\"']{n}[\"'])", src)]
    assert not missing, f"fields with no call site in elvis_tpu_torch/: {missing}"
    stale = [n for n in sorted(absorbed | pending)
             if re.search(rf"(config\.{n}\b|getattr\(config,\s*[\"']{n}[\"'])", src)]
    assert not stale, f"absorbed or pending fields with a call site: {stale}"


def _away_from_default(name):
    default = getattr(tcfg.ElvisConfig(), name)
    if isinstance(default, bool):
        return not default
    if isinstance(default, int):
        return default + 1
    if isinstance(default, float):
        return default * 2 + 1
    if isinstance(default, str):
        return default + "_x"
    return [0] if name.endswith("_devices") else ("w.npz" if name.endswith("_path") else 3)


@pytest.mark.parametrize("name", sorted(tcfg.PENDING_FIELDS))
def test_pending_field_raises_before_stage_zero(name, tmp_path):
    from elvis_tpu_torch.pipeline import run_elvis

    exp = tmp_path / "exp"
    cfg = tcfg.ElvisConfig(inpaint_backends=["diffusion"], experiment_dir=str(exp),
                           **{name: _away_from_default(name)})
    item = tcfg.PENDING_FIELDS[name]
    with pytest.raises(NotImplementedError, match=rf"{name}=.*ROADMAP\.md §1 item {item}"):
        run_elvis(cfg, device="cpu")
    assert not exp.exists()  # nothing of stage 0 ran


@pytest.mark.parametrize("field,value,item", [
    ("sr_backends", ["srnet_large"], 2),
    ("sr_backends", ["realesrgan", "srnet_large"], 2),
    ("sr_backends", ["srnet_ensemble"], 2),
    ("deblur_backends", ["deblur_net", "diffusion"], 2),
    ("codec", "x265", 4),
    ("saliency_backend", "neural", 6),
])
def test_pending_names_raise_before_stage_zero(field, value, item, tmp_path):
    from elvis_tpu_torch.pipeline import run_elvis

    kw = {"inpaint_backends": ["diffusion"], field: value}
    cfg = tcfg.ElvisConfig(experiment_dir=str(tmp_path / "exp"), **kw)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md §1 item {item}"):
        run_elvis(cfg, device="cpu")
    assert not (tmp_path / "exp").exists()


def test_default_config_raises_for_its_temporal_rows():
    """The default config is ported whole: its inpaint list names
    'temporal' and 'neural', which run now, and so do the ProPainter and
    E2FGVI knobs set away from their defaults. The per-stage device lists
    of those rows stay with item 7."""
    tcfg.check_ported(tcfg.ElvisConfig())
    assert tcfg.ElvisConfig().inpaint_backends == ["diffusion", "temporal", "neural"]
    tcfg.check_ported(tcfg.ElvisConfig(
        inpaint_backends=["diffusion", "temporal", "neural", "inpaint_net", "e2fgvi"],
        propainter_resize_ratio=0.5, propainter_ref_stride=4, propainter_neighbor_length=2,
        propainter_subvideo_length=9, propainter_mask_dilation=16,
        propainter_parallel_chunk_length=4, propainter_chunk_overlap=6, e2fgvi_ref_stride=3,
        e2fgvi_neighbor_stride=2, e2fgvi_num_ref=2, e2fgvi_mask_dilation=8,
        e2fgvi_parallel_chunk_length=4, e2fgvi_chunk_overlap=6,
        inpaint_params_path="w.npz"))
    for name in ("propainter_devices", "e2fgvi_devices"):
        with pytest.raises(NotImplementedError, match=rf"{name}=.*ROADMAP\.md §1 item 7"):
            tcfg.check_ported(tcfg.ElvisConfig(**{name: [0]}))


def test_cli_runs_on_the_card_only(tmp_path, monkeypatch):
    """The CLI asks for the card and raises without one (no CPU fallback)."""
    from elvis_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--inpaint_backends", '["diffusion"]', "--experiment_dir", str(tmp_path / "e")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not (tmp_path / "e").exists()


@pytest.mark.parametrize("knobs", [{}, {"realesrgan_tile": 64}, {"realesrgan_tile": 512,
                                                                 "realesrgan_tile_pad": 48},
                                   {"realesrgan_parallel_chunk_length": 3}])
def test_sr_runtime_knobs_ride_on_the_backend_as_in_jax(knobs):
    """realesrgan_tile / tile_pad / parallel_chunk_length become the tiling
    and chunk attributes the stage drivers read, with the JAX package's
    values."""
    from elvis_tpu.restore.backends import resolve_sr_backend as jresolve
    from elvis_tpu_torch.restore.backends import resolve_sr_backend as tresolve

    t_fn, t_prov = tresolve("realesrgan", tcfg.ElvisConfig(**knobs), device="cpu")
    j_fn, j_prov = jresolve("realesrgan", jcfg.ElvisConfig(**knobs))
    assert t_prov.startswith("progressive_neural[srnet_student:")
    for attr in ("spatial_halo_rows", "spatial_pixel_budget", "frame_chunk"):
        assert getattr(t_fn, attr, None) == getattr(j_fn, attr, None), attr


def test_srnet_large_raises_and_the_lanczos_fallback_keeps_the_knobs():
    """A pinned 'srnet_large' raises (item 2) while the port has no export
    of it, where it used to run progressive Lanczos; the generic slot keeps
    its first-existing-tier order. The Lanczos fallback carries the SR
    runtime knobs as in JAX."""
    from elvis_tpu.restore.backends import resolve_sr_backend as jresolve
    from elvis_tpu_torch.models.io import weights_path
    from elvis_tpu_torch.restore.backends import resolve_sr_backend as tresolve

    assert weights_path("srnet_large") is None
    with pytest.raises(NotImplementedError, match=r"srnet_large.*ROADMAP\.md §1 item 2"):
        tresolve("srnet_large", tcfg.ElvisConfig(), device="cpu")
    _, prov = tresolve("realesrgan", tcfg.ElvisConfig(), device="cpu")
    assert prov.startswith("progressive_neural[srnet_student:")
    knobs = {"realesrgan_tile": 96, "realesrgan_tile_pad": 40,
             "realesrgan_parallel_chunk_length": 3, "auto_load_checkpoints": False}
    t_fn, t_prov = tresolve("realesrgan", tcfg.ElvisConfig(**knobs), device="cpu")
    j_fn, j_prov = jresolve("realesrgan", jcfg.ElvisConfig(**knobs))
    assert t_prov == j_prov == "lanczos (no SR checkpoint)"
    for attr in ("spatial_halo_rows", "spatial_pixel_budget", "frame_chunk"):
        assert getattr(t_fn, attr) == getattr(j_fn, attr), attr
    assert (t_fn.spatial_halo_rows, t_fn.spatial_pixel_budget, t_fn.frame_chunk) == \
        (40, 96 * 96, 3)
