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

import numpy as np
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


# fields that were pending and are ported now: ROADMAP.md §1 items 4, 7 and 8
PORTED_FIELDS = {"encode_preset": 4, "encode_pix_fmt": 4, "minimal_figures": 8,
                 **{name: 7 for name in ("propainter_devices", "e2fgvi_devices",
                                         "realesrgan_devices", "instantir_devices",
                                         "spatial_devices", "spatial_tile_threshold",
                                         "spatial_halo")}}


@pytest.mark.parametrize("name", sorted({*tcfg.PENDING_FIELDS, *PORTED_FIELDS}))
def test_pending_field_raises_before_stage_zero(name, tmp_path):
    """A pending field away from its default raises before stage 0, naming
    its item. A field ported since passes ``check_ported``: the external
    encoders' preset and pixel format reach the codec as in JAX; the item-7
    device fields and the spatial axis configure the stage mesh (one card:
    no mesh, tests/test_torch_parallel.py covers the logical meshes);
    ``minimal_figures`` (item 8) is read by the search drivers
    (tests/test_torch_search.py), and no field is pending any more."""
    from elvis_tpu_torch.pipeline import run_elvis

    exp = tmp_path / "exp"
    value = _away_from_default(name)
    cfg = tcfg.ElvisConfig(inpaint_backends=["diffusion"], experiment_dir=str(exp),
                           **{name: value})
    if name in PORTED_FIELDS:
        assert name not in tcfg.PENDING_FIELDS
        assert PORTED_FIELDS[name] not in set(tcfg.PENDING_FIELDS.values())
        tcfg.check_ported(cfg)
        if PORTED_FIELDS[name] == 8:
            # the search drivers' figure roll-up reads it from the grid
            assert tcfg.PENDING_FIELDS == {} and tcfg._ITEMS == {}
            return
        if PORTED_FIELDS[name] == 7:
            from elvis_tpu_torch.pipeline.run import _DataParallel

            dp = _DataParallel(cfg.data_parallel, spatial=cfg.spatial_devices,
                               device_type="cpu")
            assert dp.mesh is None and dp.spatial_mesh is None  # one CPU device
            assert dp._mesh_for(getattr(cfg, name) if name.endswith("_devices") else None) \
                is None
            return
        from elvis_tpu.codec.dispatch import make_pipeline_codec as jmake
        from elvis_tpu_torch.codec.dispatch import make_pipeline_codec as tmake

        kw = {name.replace("encode_", ""): value}
        t = tmake("x265", str(tmp_path / "t"), 64, 48, device="cpu", **kw)
        j = jmake("x265", str(tmp_path / "j"), 64, 48, **kw)
        assert (t.preset, t.pix_fmt) == (j.preset, j.pix_fmt) and value in (t.preset, t.pix_fmt)
        return
    item = tcfg.PENDING_FIELDS[name]
    with pytest.raises(NotImplementedError, match=rf"{name}=.*ROADMAP\.md §1 item {item}"):
        run_elvis(cfg, device="cpu")
    assert not exp.exists()  # nothing of stage 0 ran


@pytest.mark.parametrize("field,value,item", [
    ("sr_backends", ["srnet"], 2),
    ("sr_backends", ["realesrgan", "srnet"], 2),
    ("sr_backends", ["srnet_ensemble"], 2),
    ("sr_backends", ["realesrgan", "ensemble"], 2),
    ("codec", "x265", 4),
    ("codec", "svtav1", 4),
    ("codec", "h264", None),
])
def test_pending_names_raise_before_stage_zero(field, value, item, tmp_path):
    """The names of items 2 and 4 were pending; they are ported now: no
    name is pending, ``check_ported`` takes each, and the SR name resolves
    (the provenance JAX's up to the weights file) or the codec builds as in
    JAX. A codec neither package knows raises ValueError in both."""
    from elvis_tpu.codec.dispatch import make_pipeline_codec as jmake
    from elvis_tpu_torch.codec.dispatch import make_pipeline_codec as tmake

    assert tcfg._PENDING_NAMES == {} and item not in tcfg._ITEMS
    tcfg.check_ported(tcfg.ElvisConfig(**{field: value}))
    if field == "sr_backends":
        from elvis_tpu.restore.backends import resolve_sr_backend as jresolve
        from elvis_tpu_torch.restore.backends import resolve_sr_backend as tresolve

        _, tprov = tresolve(value[-1], tcfg.ElvisConfig(), device="cpu")
        _, jprov = jresolve(value[-1], jcfg.ElvisConfig())
        assert tprov == re.sub(r"/checkpoints/(\w+)", r"/elvis_tpu_torch/weights/\1.npz", jprov)
        return
    if item is None:
        for make, kw in ((tmake, {"device": "cpu"}), (jmake, {})):
            with pytest.raises(ValueError, match="unknown codec 'h264'"):
                make(value, str(tmp_path / "c"), 64, 48, **kw)
        return
    t = tmake(value, str(tmp_path / "t"), 64, 48, device="cpu")
    assert t.name == jmake(value, str(tmp_path / "j"), 64, 48).name == value


def test_default_config_raises_for_its_temporal_rows():
    """The default config is ported whole: its inpaint list names
    'temporal' and 'neural', which run now, and so do the ProPainter and
    E2FGVI knobs set away from their defaults and, since item 7, the
    per-stage device lists of those rows."""
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
        tcfg.check_ported(tcfg.ElvisConfig(**{name: [0, 1]}))
    assert 7 not in tcfg._ITEMS and "data_parallel" not in tcfg.ABSORBED_FIELDS


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
    """A pinned 'srnet_large' loads the exported tier (256 x 8, with JAX's
    provenance) and carries the SR runtime knobs, where it raised while the
    port had no export of it; the generic slot keeps its first-existing-tier
    order. The Lanczos fallback carries the knobs as in JAX."""
    from elvis_tpu.restore.backends import resolve_sr_backend as jresolve
    from elvis_tpu_torch.models.io import weights_path
    from elvis_tpu_torch.restore.backends import resolve_sr_backend as tresolve

    knobs = {"realesrgan_tile": 96, "realesrgan_tile_pad": 40,
             "realesrgan_parallel_chunk_length": 3}
    t_fn, t_prov = tresolve("srnet_large", tcfg.ElvisConfig(**knobs), device="cpu")
    assert t_prov == f"progressive_neural[srnet_large:{weights_path('srnet_large')}]"
    assert (t_fn.spatial_halo_rows, t_fn.spatial_pixel_budget, t_fn.frame_chunk) == \
        (40, 96 * 96, 3)
    frames = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    assert t_fn(frames, torch.ones((1, 2, 2), dtype=torch.int32), 8).shape == frames.shape
    _, prov = tresolve("realesrgan", tcfg.ElvisConfig(), device="cpu")
    assert prov.startswith("progressive_neural[srnet_student:")
    knobs["auto_load_checkpoints"] = False
    t_fn, t_prov = tresolve("realesrgan", tcfg.ElvisConfig(**knobs), device="cpu")
    j_fn, j_prov = jresolve("realesrgan", jcfg.ElvisConfig(**knobs))
    assert t_prov == j_prov == "lanczos (no SR checkpoint)"
    for attr in ("spatial_halo_rows", "spatial_pixel_budget", "frame_chunk"):
        assert getattr(t_fn, attr) == getattr(j_fn, attr), attr
    assert (t_fn.spatial_halo_rows, t_fn.spatial_pixel_budget, t_fn.frame_chunk) == \
        (40, 96 * 96, 3)


# fields and names ported in this slice: check_ported takes each, and the
# backend it names resolves and runs on a small clip
PORTED_CASES = [
    ("realesrgan_fp32", True), ("instantir_seed", 7), ("instantir_batch_size", 2),
    ("enable_dct_dampen", True), ("saliency_backend", "neural"),
    *(("sr_backends", ["realesrgan", n]) for n in ("lanczos", "hybrid", "level_seq",
                                                    "naive_sr", "srnet_large", "srnet_4k")),
    *(("deblur_backends", ["deblur_net", n]) for n in ("diffusion", "naive_diffusion")),
]


@pytest.mark.parametrize("field,value", PORTED_CASES)
def test_ported_field_or_name_runs(field, value):
    from elvis_tpu_torch.degrade import dct_dampen
    from elvis_tpu_torch.restore import restore_dct_dampen_inverse
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend, resolve_sr_backend
    from elvis_tpu_torch.scoring import get_saliency_fn

    cfg = tcfg.ElvisConfig(**{field: value})
    tcfg.check_ported(cfg)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8))
    maps = torch.from_numpy(rng.integers(0, 3, (2, 2, 2)).astype(np.int32))
    if field == "enable_dct_dampen":
        damped, levels = dct_dampen(frames, maps / 3.0, 8)
        out = restore_dct_dampen_inverse(damped, levels, 8)
    elif field == "saliency_backend":
        out = get_saliency_fn(value)(frames)
        assert out.shape == frames.shape[:3]
    else:
        resolve = resolve_sr_backend if field in ("sr_backends", "realesrgan_fp32") \
            else resolve_deblur_backend
        name = value[-1] if isinstance(value, list) else (
            "realesrgan" if field == "realesrgan_fp32" else "diffusion")
        fn, prov = resolve(name, cfg, device="cpu")
        out = fn(frames, maps, 8)
        assert out.shape == frames.shape and out.dtype == torch.uint8
        if field == "instantir_seed":
            assert prov.endswith("[seed=7]")
        if field == "instantir_batch_size":
            assert fn.frame_chunk == 2
        if field == "realesrgan_fp32":
            assert prov.endswith("+fp32]")
    assert bool(torch.isfinite(out.float()).all())


def test_run_elvis_takes_every_ported_field_and_name(tmp_path):
    """One port run with every field and name of ``PORTED_CASES`` at once:
    no NotImplementedError, every row finite."""
    from elvis_tpu_torch.pipeline import run_elvis

    kw = {field: value for field, value in PORTED_CASES if not isinstance(value, list)}
    for field in ("sr_backends", "deblur_backends"):
        names = [v[-1] for f, v in PORTED_CASES if f == field]
        kw[field] = [("realesrgan" if field == "sr_backends" else "deblur_net"), *names]
    cfg = tcfg.ElvisConfig(reference_video="synthetic://moving?frames=4&fps=30", width=48,
                           height=32, inpaint_backends=["diffusion"], enable_vmaf=False,
                           enable_fvmd=False, stage_cache=False, verbose=False,
                           target_bitrate_override=50_000, experiment_dir=str(tmp_path), **kw)
    r = run_elvis(cfg, device="cpu")
    rows = [k for k, v in r.items() if isinstance(v, dict) and "foreground" in v]
    assert len(rows) == 16 and "ELVIS v2 Dampen" in rows
    for row in rows:
        assert np.isfinite(r[row]["foreground"]["psnr_mean"]), row
    assert r["parameters"]["derived"]["backends"]["PRESLEY Deblur diffusion"].endswith(
        "[seed=7]")
