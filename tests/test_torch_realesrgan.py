"""Real-ESRGAN's 2x RRDBNet (``RealESRGANx2``, the ``realesrgan_x2plus``
tier) on the CPU at a small depth: the port against the plain reference
``tests/_ref_realesrgan.py`` on the benchmark's seeded weights, the tier
through ``resolve_sr_backend`` and the progressive loop, its weights file,
its spans and counters, and the benchmark's FLOP count of it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elvis_tpu_torch.models import io as tio
from elvis_tpu_torch.models.srnet import RealESRGANx2, srnet_upsample_fn
from elvis_tpu_torch.pipeline.config import ElvisConfig
from elvis_tpu_torch.restore import backends
from elvis_tpu_torch.utils.trace import counter

from port_bench.paths.restore_seeded import seeded_weights

from _ref_realesrgan import ReferenceRealESRGAN

BLOCKS = 2  # RRDBs; every width as published


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def state():
    """The benchmark configuration's seeded weights (BasicSR's initialisation
    at the scales it lists under ``assumed``) at two RRDBs, as a state dict
    under BasicSR's names, with ``conv_last`` at a gain that gives two RRDBs
    about the output spread of 23 at the configuration's 0.5 (23 RRDBs of
    these weights grow the features some 70 times, two by about 1.5)."""
    cfg = json.loads((Path(__file__).resolve().parents[1]
                      / "port_bench/configs/realesrgan_x2plus_1080p.json").read_text())
    arch = dict(cfg["arch"], num_block=BLOCKS)
    layers = seeded_weights(arch, 19, dict(cfg["assumed"], conv_last_weight_scale=7.0))
    return {f"{name}.{leaf}": torch.from_numpy(v) for name, (w, b) in layers.items()
            for leaf, v in (("weight", w), ("bias", b))}


def _frames(n, h, w, seed=0):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    base = 128 + 60 * torch.sin(xx / 3.0) + 40 * torch.cos(yy / 2.5)
    img = torch.stack([base, base.roll(2, 1), base.roll(-1, 0)], -1)
    noise = torch.randn(n, h, w, 3, generator=torch.Generator().manual_seed(seed)) * 12
    return torch.clamp(img + noise, 0, 255)


def _model(state, dtype):
    model = RealESRGANx2(num_block=BLOCKS, dtype=dtype)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


@pytest.mark.parametrize("h,w", [(15, 24), (16, 24)])  # odd: the mod-pad and the crop
def test_float32_matches_the_reference(state, h, w):
    x = _frames(2, h, w)
    want = ReferenceRealESRGAN(state, BLOCKS)(x)
    with torch.inference_mode():
        got = _model(state, torch.float32)(x)
    assert got.shape == (2, 2 * h, 2 * w, 3) == want.shape
    assert 20 < float(want.std()) and float(((want <= 0) | (want >= 255)).float().mean()) < 0.05
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bf16_trunk_within_its_rounding(state):
    """bf16 keeps 8 significant bits (2^-9 relative per rounding); about 40
    roundings of conv outputs and residual sums lie between input and
    output here, so the output moves by a fraction of an LSB on average and
    by under one at most (0.12 mean and 0.78 max measured; bounds 2.4x and
    2.6x)."""
    x = _frames(2, 15, 24, seed=1)
    want = ReferenceRealESRGAN(state, BLOCKS)(x)
    with torch.inference_mode():
        got = _model(state, torch.bfloat16)(x)
    err = (got - want).abs()
    assert float(err.mean()) < 0.3 and float(err.max()) < 2.0, (err.mean(), err.max())


def _write(path, state, num_block=BLOCKS, scale=2):
    tio.write_npz(str(path), state, {"arch": tio.REALESRGAN_ARCH, "num_feat": 64,
                                     "num_grow_ch": 32, "num_block": num_block, "scale": scale})
    return str(path)


def test_weights_file_round_trips_under_basicsr_names(state, tmp_path):
    path = _write(tmp_path / "x2.npz", state)
    with np.load(path) as data:
        assert "params/body/1/rdb3/conv5/kernel" in data.files
        assert "params/conv_first/kernel" in data.files and "params/conv_last/bias" in data.files
    model = tio.load_srnet(path, "cpu")
    assert isinstance(model, RealESRGANx2) and model.num_block == BLOCKS
    got = model.state_dict()
    assert set(got) == set(state)
    assert got["conv_last.weight"].dtype == torch.float32
    assert got["conv_hr.weight"].dtype == got["body.0.rdb1.conv1.bias"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], v.to(got[k].dtype)) for k, v in state.items())
    assert tio.model_meta(model)["arch"] == "realesrgan_rrdbnet"
    assert tio.srnet_arch(backends._sr_meta(path)) == ("realesrgan", 64, 32, BLOCKS, 2)
    assert backends._TIER_ARCH["realesrgan_x2plus"] == ("realesrgan", 64, 32, 23, 2)


def test_tier_drives_the_progressive_restore_as_the_reference(state, tmp_path, monkeypatch):
    from port_bench.harness import content
    from port_bench.reference.restore import restore_segment

    monkeypatch.setitem(backends._TIER_ARCH, "realesrgan_x2plus", ("realesrgan", 64, 32, BLOCKS, 2))
    path = _write(tmp_path / "x2.npz", state)
    fn, prov = backends.resolve_sr_backend("realesrgan_x2plus",
                                           ElvisConfig(srnet_params_path=path), device="cpu")
    assert prov == f"progressive_neural[realesrgan_x2plus:{path}]"
    gen = content.generator(7, "cpu")
    levels = content.make_levels({"max_level": 3, "field_cells": 3}, 1, 2, 8, 8, gen, "cpu")[0]
    frames = _frames(2, 64, 64, seed=2).round().to(torch.uint8)
    got = fn(frames, levels, 8)
    want = restore_segment(ReferenceRealESRGAN(state, BLOCKS), frames, levels, 8)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs().float()
    # the bf16 net against the float32 one, as in the test above, rounded
    assert float(diff.mean()) < 0.2 and float(diff.max()) <= 3


def test_generic_slot_and_wrong_files(state, tmp_path):
    path = _write(tmp_path / "x2.npz", state)  # 2 RRDBs, not the tier's 23
    cfg = ElvisConfig(srnet_params_path=path)
    with pytest.raises(ValueError, match="realesrgan_x2plus"):
        backends.resolve_sr_backend("realesrgan_x2plus", cfg, device="cpu")
    student = tio.weights_path("srnet_student")
    with pytest.raises(ValueError, match="not the realesrgan_x2plus tier"):
        backends.resolve_sr_backend("realesrgan_x2plus", ElvisConfig(srnet_params_path=student),
                                    device="cpu")
    # the generic slot never takes it; without a file the tier is Lanczos
    _, prov = backends.resolve_sr_backend("realesrgan", cfg, device="cpu")
    assert "realesrgan_x2plus" not in prov
    _, prov = backends.resolve_sr_backend("realesrgan_x2plus", ElvisConfig(), device="cpu")
    assert prov == "lanczos (no SR checkpoint)"
    x4 = _write(tmp_path / "x4.npz", state, scale=4)
    with pytest.raises(ValueError, match="2x one only"):
        tio.load_srnet(x4, "cpu")


def test_spans_and_modpad_counter(state):
    model = _model(state, torch.float32)
    up = srnet_upsample_fn(model)
    assert not hasattr(up, "phase_fn")
    nets = counter("nets")
    before = nets["modpad"]
    up(_frames(1, 16, 24))
    assert nets["modpad"] == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        up(_frames(1, 15, 24))
    assert nets["modpad"] == before + 1
    names = [e.key for e in prof.key_averages()]
    for span in ("srnet.body", "srnet.upsample_head", "srnet.modpad"):
        assert span in names, span


def test_benchmark_flop_count_equals_the_convs_run(state, monkeypatch):
    """``port_bench/counts/realesrgan.py`` against the convolutions the
    model launches, counted from their weights and output shapes."""
    from port_bench.counts import realesrgan as rc

    arch = {"num_feat": 64, "num_grow_ch": 32, "num_block": BLOCKS}
    model = _model(state, torch.float32)
    layers = [(m.in_channels, m.out_channels) for m in model.modules()
              if isinstance(m, torch.nn.Conv2d)]
    assert layers == [(cin, cout) for cin, cout, _, _ in rc.conv_layers(arch)]
    seen = []
    conv2d = torch.nn.functional.conv2d

    def counted(x, w, *a, **kw):
        out = conv2d(x, w, *a, **kw)
        seen.append(2 * w[0].numel() * out.shape[0] * out.shape[1] * out.shape[2] * out.shape[3])
        return out

    monkeypatch.setattr(torch.nn.functional, "conv2d", counted)
    frames, h, w = 2, 60, 72  # stage inputs 15x18, 30x36 (max level 2)
    with torch.inference_mode():
        for sh, sw in rc.stage_shapes(h, w, 2):
            model(_frames(frames, sh, sw))
    assert len(seen) == 2 * len(layers)
    assert sum(seen) == rc.segment_flops(arch, frames, h, w, 2)
