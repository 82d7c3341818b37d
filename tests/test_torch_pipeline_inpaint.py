"""Port parity: ``run_elvis`` with the DEFAULT ``ElvisConfig`` (all nine
rows: ELVIS ProPainter and ELVIS E2FGVI included), ``elvis_tpu_torch``
against ``elvis_tpu``, on the same synthetic clip (6 frames of 96x64), on
the CPU.

Only what a 96x64 run on the CPU needs differs from the default:
``enable_vmaf=False``, ``stage_cache=False``,
``target_bitrate_override=100_000`` (the W*H*fps model gives ~2 kbit/s at
this size), and the JAX side's ``data_parallel=False`` (the conftest's
8-device CPU mesh would cost its run time and change nothing: the port
has one card). Tolerances are ``test_torch_pipeline.py``'s: bitrate 1%,
PSNR 0.1 dB, SSIM 2e-3, LPIPS 1e-3 (absolute), MSE 1% and FVMD 10%
(relative). Both fills read the server's motion hint: their provenances
end in ``+motion_hint``. A second run on the same directory is served from
the stage cache, the two new restores included.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    BITRATE_RTOL,
    FVMD_RTOL,
    LPIPS_ATOL,
    MSE_RTOL,
    PSNR_ATOL_DB,
    SSIM_ATOL,
)

ROWS = ["Baseline", "PRESLEY QP", "ELVIS CV2", "ELVIS ProPainter", "ELVIS E2FGVI",
        "PRESLEY RealESRGAN", "PRESLEY InstantIR", "PRESLEY Lanczos", "PRESLEY Unsharp"]
CONFIG = dict(reference_video="synthetic://moving?frames=6&fps=30", width=96, height=64,
              enable_vmaf=False, stage_cache=False, target_bitrate_override=100_000,
              verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, _one_thread):
    from elvis_tpu.pipeline import ElvisConfig as JConfig, run_elvis as jrun
    from elvis_tpu_torch.pipeline import ElvisConfig as TConfig, run_elvis as trun

    jdir, tdir = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "torch"))
    j = jrun(JConfig(experiment_dir=jdir, data_parallel=False, **CONFIG))
    t = trun(TConfig(experiment_dir=tdir, **CONFIG), device="cpu")
    return t, j


def test_default_config_writes_the_nine_rows(runs):
    t, j = runs
    rows_t = [k for k, v in t.items() if isinstance(v, dict) and "foreground" in v]
    rows_j = [k for k, v in j.items() if isinstance(v, dict) and "foreground" in v]
    assert rows_t == rows_j == ROWS
    assert t["parameters"]["config"]["inpaint_backends"] == ["diffusion", "temporal", "neural"]
    assert list(t["execution_times_seconds"]) == list(j["execution_times_seconds"])


@pytest.mark.parametrize("row", ROWS)
def test_row_within_tolerance(runs, row):
    t, j = runs
    assert abs(t[row]["bitrate_mbps"] - j[row]["bitrate_mbps"]) <= \
        BITRATE_RTOL * j[row]["bitrate_mbps"]
    for region in ("foreground", "background"):
        a, b = t[row][region], j[row][region]
        assert abs(a["psnr_mean"] - b["psnr_mean"]) <= PSNR_ATOL_DB, region
        assert abs(a["ssim_mean"] - b["ssim_mean"]) <= SSIM_ATOL, region
        assert abs(a["lpips_mean"] - b["lpips_mean"]) <= LPIPS_ATOL, region
        assert abs(a["mse_mean"] - b["mse_mean"]) <= MSE_RTOL * b["mse_mean"], region
        assert abs(a["fvmd"] - b["fvmd"]) <= FVMD_RTOL * b["fvmd"], region
        for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
            assert np.isfinite(a[key]), (region, key)


def test_fills_read_the_motion_hint(runs):
    from elvis_tpu_torch.models.io import weights_path

    t, j = runs
    tb = t["parameters"]["derived"]["backends"]
    jb = j["parameters"]["derived"]["backends"]
    assert tb["ELVIS ProPainter"] == jb["ELVIS ProPainter"] == \
        "temporal_propagation[window=8,overlap=16,ref_stride=20]+motion_hint"
    assert tb["ELVIS E2FGVI"] == \
        f"inpaint_net:{weights_path('inpaint')}[window=10,overlap=20]+motion_hint"
    assert jb["ELVIS E2FGVI"].endswith("[window=10,overlap=20]+motion_hint")
    assert tb["ELVIS CV2"] == jb["ELVIS CV2"] == "pde_diffusion"
    # the two rows ride the shrunk branch's bits, as ELVIS CV2 does
    for row in ("ELVIS ProPainter", "ELVIS E2FGVI"):
        assert t[row]["bitrate_mbps"] == t["ELVIS CV2"]["bitrate_mbps"]


def test_second_run_serves_the_new_restores_from_the_cache(tmp_path):
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    cfg = ElvisConfig(**{**CONFIG, "stage_cache": True, "enable_fvmd": False,
                         "generate_opencv_benchmarks": False,
                         "sr_backends": ["progressive_lanczos"], "deblur_backends": ["unsharp"],
                         "max_frames": 4, "experiment_dir": str(tmp_path / "exp")})
    first = run_elvis(cfg, device="cpu")
    second = run_elvis(cfg, device="cpu")
    stages = ["scoring", "baseline_encode", "shrink_encode", "roi_encode", "downsample_encode",
              "gaussian_encode", "inpaint_diffusion", "inpaint_temporal", "inpaint_neural",
              "sr_progressive_lanczos", "deblur_unsharp"]
    assert first["stage_cache"] == {"hits": [], "misses": stages}
    assert second["stage_cache"] == {"hits": stages, "misses": []}
    for row in ("ELVIS ProPainter", "ELVIS E2FGVI"):
        second[row].pop("evaluation_seconds"), first[row].pop("evaluation_seconds")
        assert json.dumps(second[row]) == json.dumps(first[row])
