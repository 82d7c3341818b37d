"""The plain reference against the port on small CPU crops: the SR nets and
the progressive loop (the port forced to float32, and as shipped in
bfloat16), scoring, levels and the degrade, and the NVC decoder."""

import json

import pytest
import torch

from port_bench.harness import content, spec
from port_bench.reference import nvc as ref_nvc
from port_bench.reference import scoring as ref_scoring
from port_bench.reference.restore import restore_segment
from port_bench.reference.srnet import ReferenceSR

CONFIGS = ["elvis_student_1080p", "elvis_rrdb_1080p"]


def _config(name):
    with open(spec.ROOT / spec.BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def _inputs(seed=2**31 + 11, n=2, h=64, w=96):
    mix = spec.traffic("segments_1080p_restore")
    gen = content.generator(seed, "cpu")
    src = content.make_segments(mix["content"], 1, n, h, w, gen, "cpu")[0]
    lv = content.make_levels(mix["levels"], 1, n, h // 8, w // 8, gen, "cpu")[0]
    return src, lv, content.degrade(src, lv, 8)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_restore_matches_the_port_in_float32(name):
    from elvis_tpu_torch.models.io import load_srnet
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.restore.progressive import progressive_restore

    cfg = _config(name)
    path = str(spec.ROOT / cfg["weights"])
    _, lv, deg = _inputs()
    model = load_srnet(path, "cpu")
    model.dtype = torch.float32
    port = progressive_restore(deg, lv, 8, upsample_fn=srnet_upsample_fn(model))
    ref = restore_segment(ReferenceSR(path, "cpu"), deg, lv, 8)
    diff = (port.int() - ref.int()).abs()
    assert int(diff.max()) <= 1
    assert float(diff.float().mean()) < 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_backend_within_the_limit_and_the_control_beyond(name):
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    cfg = _config(name)
    path = str(spec.ROOT / cfg["weights"])
    _, lv, deg = _inputs()
    backend, prov = resolve_sr_backend(cfg["sr_backend"], ElvisConfig(), device="cpu")
    assert f"[{cfg['sr_tier']}:" in prov
    ref = restore_segment(ReferenceSR(path, "cpu"), deg, lv, 8)
    limit = cfg["checks"]["restore"]["limits"]["frame_mae_lsb"]
    gap = (backend(deg, lv, 8).int() - ref.int()).abs().float().mean(dim=(1, 2, 3)).max()
    control = restore_segment(ReferenceSR(path, "cpu", "fp8"), deg, lv, 8)
    ctl = (control.int() - ref.int()).abs().float().mean(dim=(1, 2, 3)).max()
    assert float(gap) <= limit < float(ctl)


def test_reference_scoring_and_degrade_match_the_port():
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.scoring import (get_saliency_fn, removability_scores,
                                         saliency_to_block_mask, spatial_temporal_complexity)

    src, _, _ = _inputs(n=4, h=72, w=104)
    cx = spatial_temporal_complexity(src, 8)
    sal = get_saliency_fn("motion_contrast")(src)
    scores = removability_scores(cx.SC, cx.TC, saliency_to_block_mask(sal, 8))
    degraded, levels = adaptive_downsample(src, scores, 8)
    rs = ref_scoring.scores(src)
    rl = ref_scoring.levels_of(rs)
    assert float((ref_scoring.saliency(src) - sal).abs().max()) < 1e-6
    assert float((rs - scores).abs().max()) < 1e-6
    assert torch.equal(rl, levels)
    assert torch.equal(ref_scoring.degrade(src, rl), degraded)


def test_reference_level_table_matches_the_port():
    import numpy as np

    from elvis_tpu_torch.kernels.block_transform import resample_matrix_table

    np.testing.assert_allclose(ref_scoring.level_table(3), resample_matrix_table(8, "linear"),
                               atol=1e-12)


def test_reference_decoder_matches_the_port(tmp_path):
    from elvis_tpu_torch.codec.nvc import codec as nvc

    src, _, _ = _inputs(n=8, h=48, w=80)
    cfg = _config("elvis_student_1080p")
    from port_bench.paths.encode import encode_kwargs

    stream = nvc.encode(src, device="cpu", **encode_kwargs(cfg))
    port, _ = nvc.decode(stream, device="cpu")
    ref = ref_nvc.decode(stream, torch.device("cpu"), tmp_path)
    assert ref.shape == src.shape
    assert torch.equal(port, ref)
    mse = ((ref.float() - src.float()) ** 2).mean()
    assert 0 < float(mse) < 200
