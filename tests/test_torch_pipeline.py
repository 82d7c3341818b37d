"""Port parity: ``run_elvis`` end to end, ``elvis_tpu_torch`` against
``elvis_tpu``, on the same synthetic clip (6 frames of 96x64), on the CPU.

Configuration: the default ``ElvisConfig`` with
``inpaint_backends=["diffusion"]`` (the slice's configuration: seven of
the nine default rows), ``enable_vmaf=False``, ``stage_cache=False``,
``target_bitrate_override=100_000`` (the W*H*fps model gives ~2 kbit/s at
this size), and ``data_parallel=False``: the conftest's 8-device CPU mesh
would cost the JAX run ~25 s and change nothing (the port has one card). Both packages encode with their own NVC encoders, which are
not bit-exact (``ROADMAP.md`` §3), restore with the same shipped weights
(bf16 nets in both) and evaluate with their own metrics.

Tolerances, per row: bitrate within 1%, foreground and background PSNR
within 0.1 dB, SSIM within 2e-3, LPIPS within 1e-3 (absolute), MSE within
1% and FVMD within 10% (relative). The largest gaps seen on this clip were
0.31% in MSE (PRESLEY InstantIR, foreground: the bf16 net) and 4.4% in FVMD
(ELVIS CV2, background); every other row's FVMD was equal. FVMD's features
are integer block motion binned into histograms, so a one-LSB difference in
the PDE fill (``test_torch_inpaint_diffusion.py``) can move a vector to
another bin: its limit is looser than the pixel metrics'. The JSON
has the JAX package's keys at every depth; its values are equal apart
from times, host memory and paths.

A second pair of runs takes every backend the port added for the
JAX package's remaining names (``BACKEND_CONFIG``: the SR names
``srnet_large``, ``srnet_4k``, ``lanczos``, ``hybrid``, ``level_seq``,
``naive_sr``; the deblur names ``diffusion`` and ``naive_diffusion``; the
DCT-dampen branch; the neural saliency), sixteen rows, each held to the
tolerances above, except the ``diffusion`` row: the two packages draw its
SDEdit noise from different generators (``jax.random`` and a
``torch.Generator`` seeded alike), so it is held to the larger of those
tolerances and twice JAX's own spread between ``instantir_seed`` 42 and 43
on this clip (``DIFFUSION_SEED_SPREAD``, measured). Largest gaps seen on
the other fifteen rows: PSNR 0.0135 dB, SSIM 1.4e-4, MSE 0.34%, FVMD 7.6%
(PRESLEY InstantIR); on the diffusion row PSNR 0.082 dB, MSE 1.59%, FVMD
33% (foreground).
"""

import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

BITRATE_RTOL = 0.01
PSNR_ATOL_DB = 0.1
SSIM_ATOL = 2e-3
LPIPS_ATOL = 1e-3
MSE_RTOL = 0.01
FVMD_RTOL = 0.10
ROWS = ["Baseline", "PRESLEY QP", "ELVIS CV2", "PRESLEY RealESRGAN", "PRESLEY InstantIR",
        "PRESLEY Lanczos", "PRESLEY Unsharp"]
CONFIG = dict(reference_video="synthetic://moving?frames=6&fps=30", width=96, height=64,
              inpaint_backends=["diffusion"], enable_vmaf=False, stage_cache=False,
              target_bitrate_override=100_000, verbose=False,
              data_parallel=False)  # JAX: no 8-device CPU mesh (on one card a no-op)


BACKEND_CONFIG = dict(
    CONFIG,
    sr_backends=["realesrgan", "srnet_large", "srnet_4k", "lanczos", "hybrid", "level_seq",
                 "naive_sr"],
    deblur_backends=["deblur_net", "diffusion", "naive_diffusion"],
    enable_dct_dampen=True, saliency_backend="neural")
BACKEND_ROWS = ["Baseline", "PRESLEY QP", "ELVIS v2 Dampen", "ELVIS CV2", "PRESLEY RealESRGAN",
                *(f"PRESLEY SR {n}" for n in BACKEND_CONFIG["sr_backends"][1:]),
                "PRESLEY InstantIR", "PRESLEY Deblur diffusion",
                "PRESLEY Deblur naive_diffusion", "PRESLEY Lanczos", "PRESLEY Unsharp"]
# |JAX(instantir_seed=43) - JAX(42)| on the diffusion row of BACKEND_CONFIG's
# run (JAX on the CPU): absolute for PSNR, SSIM and LPIPS, relative for MSE
# and FVMD
DIFFUSION_SEED_SPREAD = {
    "foreground": {"psnr_mean": 0.04553, "ssim_mean": 7.311e-05, "lpips_mean": 9.72e-08,
                   "mse_mean": 0.008116, "fvmd": 0.2109},
    "background": {"psnr_mean": 0.02575, "ssim_mean": 2.283e-03, "lpips_mean": 2.69e-06,
                   "mse_mean": 0.006289, "fvmd": 0.3810},
}


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
    j = jrun(JConfig(experiment_dir=jdir, **CONFIG))
    t = trun(TConfig(experiment_dir=tdir, **CONFIG), device="cpu")
    return t, j, tdir, jdir


@pytest.fixture(scope="module")
def backend_runs(tmp_path_factory, _one_thread):
    from elvis_tpu.pipeline import ElvisConfig as JConfig, run_elvis as jrun
    from elvis_tpu_torch.pipeline import ElvisConfig as TConfig, run_elvis as trun

    jdir, tdir = (str(tmp_path_factory.mktemp(k)) for k in ("jax_b", "torch_b"))
    j = jrun(JConfig(experiment_dir=jdir, **BACKEND_CONFIG))
    t = trun(TConfig(experiment_dir=tdir, **BACKEND_CONFIG), device="cpu")
    return t, j, tdir, jdir


def _rows_close(a, b, tol=None):
    """Every metric of row ``a`` within the module's tolerances of ``b``, or
    within the larger ``tol`` (region -> metric -> bound, relative for MSE and
    FVMD) where one is given."""
    assert abs(a["bitrate_mbps"] - b["bitrate_mbps"]) <= BITRATE_RTOL * b["bitrate_mbps"]
    for region in ("foreground", "background"):
        x, y = a[region], b[region]
        lim = {"psnr_mean": PSNR_ATOL_DB, "ssim_mean": SSIM_ATOL, "lpips_mean": LPIPS_ATOL,
               "mse_mean": MSE_RTOL, "fvmd": FVMD_RTOL}
        for key, bound in (tol or {}).get(region, {}).items():
            lim[key] = max(lim[key], bound)
        for key in ("psnr_mean", "ssim_mean", "lpips_mean"):
            assert abs(x[key] - y[key]) <= lim[key], (region, key, x[key], y[key])
        for key in ("mse_mean", "fvmd"):
            assert abs(x[key] - y[key]) <= lim[key] * y[key], (region, key, x[key], y[key])
        for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
            assert np.isfinite(x[key]), (region, key)


def test_rows_are_the_same_set(runs):
    t, j, _, _ = runs
    rows_t = [k for k, v in t.items() if isinstance(v, dict) and "foreground" in v]
    rows_j = [k for k, v in j.items() if isinstance(v, dict) and "foreground" in v]
    assert rows_t == rows_j == ROWS


@pytest.mark.parametrize("row", ROWS)
def test_row_within_tolerance(runs, row):
    t, j, _, _ = runs
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


def test_backend_rows_are_the_same_set(backend_runs):
    t, j, _, _ = backend_runs
    rows_t = [k for k, v in t.items() if isinstance(v, dict) and "foreground" in v]
    rows_j = [k for k, v in j.items() if isinstance(v, dict) and "foreground" in v]
    assert rows_t == rows_j == BACKEND_ROWS


@pytest.mark.parametrize("row", [r for r in BACKEND_ROWS if r != "PRESLEY Deblur diffusion"])
def test_backend_row_within_tolerance(backend_runs, row):
    t, j, _, _ = backend_runs
    _rows_close(t[row], j[row])


def test_diffusion_row_within_the_seed_spread(backend_runs):
    """Different noise: each metric within the larger of the module's
    tolerance and twice JAX's own spread between two seeds."""
    t, j, _, _ = backend_runs
    row = "PRESLEY Deblur diffusion"
    _rows_close(t[row], j[row], {region: {k: 2 * v for k, v in spread.items()}
                                 for region, spread in DIFFUSION_SEED_SPREAD.items()})
    # and it is the restorer's work: far from the identity restorer's row
    # (naive_diffusion returns the decoded blur branch; 3.16 dB apart here)
    assert abs(t[row]["background"]["psnr_mean"]
               - t["PRESLEY Deblur naive_diffusion"]["background"]["psnr_mean"]) > 1.0


def test_backend_provenances_and_dampen_sidecar_equal_jax(backend_runs):
    t, j, tdir, jdir = backend_runs
    tprov = t["parameters"]["derived"]["backends"]
    jprov = j["parameters"]["derived"]["backends"]
    assert sorted(tprov) == sorted(jprov)
    for label, prov in jprov.items():  # the same strings, the weights file for the checkpoint
        want = re.sub(r"/checkpoints/(\w+)", r"/elvis_tpu_torch/weights/\1.npz", prov)
        assert tprov[label] == want, label
    assert tprov["PRESLEY Deblur diffusion"].endswith("diffusion.npz[seed=42]")
    assert tprov["PRESLEY SR srnet_4k"] == "lanczos (no 4k finisher checkpoint)"
    with np.load(os.path.join(tdir, "maps", "dampen_maps.npz")) as tm, \
            np.load(os.path.join(jdir, "maps", "dampen_maps.npz")) as jm:
        assert sorted(tm.files) == sorted(jm.files)
        for k in jm.files:
            assert np.array_equal(tm[k], jm[k]), k
    assert "DCT Dampen Branch" in t["execution_times_seconds"]
    assert list(t["execution_times_seconds"]) == list(j["execution_times_seconds"])


_VOLATILE = ("execution_times_seconds", "stage_rss_gb", "total_pipeline_seconds",
             "evaluation_seconds", "experiment_dir", "analysis_results_path")


def _keys_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if not isinstance(b, dict):
        return
    assert sorted(a) == sorted(b), path
    for k in b:
        _keys_equal(a[k], b[k], f"{path}/{k}")


def _values_equal(a, b, path=""):
    if path.rsplit("/", 1)[-1] in _VOLATILE or path.endswith("derived/backends"):
        return
    if isinstance(b, dict):
        for k in b:
            _values_equal(a[k], b[k], f"{path}/{k}")
    elif path.count("/") == 1 or "/parameters/" in path or path.startswith("/stage_cache"):
        assert a == b, path  # everything outside the per-row metrics


def test_json_keys_equal_at_every_depth(runs):
    _, _, tdir, jdir = runs
    with open(os.path.join(tdir, "analysis_results.json")) as f:
        t = json.load(f)
    with open(os.path.join(jdir, "analysis_results.json")) as f:
        j = json.load(f)
    _keys_equal(t, j)
    _values_equal(t, j)
    assert t["parameters"]["config"]["experiment_dir"] == tdir
    assert list(t["execution_times_seconds"]) == list(j["execution_times_seconds"])
    assert t["parameters"]["derived"]["backends"]["ELVIS CV2"] == "pde_diffusion"
    assert t["parameters"]["derived"]["backends"]["PRESLEY RealESRGAN"].startswith(
        "progressive_neural[srnet_student:")


def test_sidecars_and_masks_written(runs):
    _, _, tdir, jdir = runs
    for d in (tdir, jdir):
        assert os.path.exists(os.path.join(d, "shrink_masks_8.npz"))
        assert os.path.exists(os.path.join(d, "maps", "downsample_maps.npz"))
        assert os.path.exists(os.path.join(d, "maps", "gaussian_maps.npz"))
    names = sorted(os.listdir(os.path.join(tdir, "maps", "saliency_masks")))
    assert names == sorted(os.listdir(os.path.join(jdir, "maps", "saliency_masks")))
    assert len(names) == 6
    for name in names:  # the port's masks, read by PIL, equal the JAX package's
        a = np.asarray(Image.open(os.path.join(tdir, "maps", "saliency_masks", name)))
        b = np.asarray(Image.open(os.path.join(jdir, "maps", "saliency_masks", name)))
        assert (a != b).mean() < 1e-3
    with np.load(os.path.join(tdir, "shrink_masks_8.npz")) as tm, \
            np.load(os.path.join(jdir, "shrink_masks_8.npz")) as jm:
        assert sorted(tm.files) == sorted(jm.files)
        for k in jm.files:  # removal masks and the motion hint: equal
            assert np.array_equal(tm[k], jm[k]), k


def test_second_run_is_served_from_the_stage_cache(tmp_path):
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    cfg = ElvisConfig(**{**CONFIG, "stage_cache": True, "enable_fvmd": False,
                         "experiment_dir": str(tmp_path / "exp")})
    stats = {}
    first = run_elvis(cfg, device="cpu", stats=stats)
    second = run_elvis(cfg, device="cpu")
    # stats: each branch's stream (the Baseline row's bits), no device peaks off CUDA
    assert sorted(stats["streams"]) == ["baseline", "downsampled", "gaussian", "roi", "shrunk"]
    assert first["Baseline"]["bitrate_mbps"] == pytest.approx(
        len(stats["streams"]["baseline"]) * 8 / first["video_length_seconds"] / 1e6)
    assert stats["stage_peak_bytes"] == {}
    stages = ["scoring", "baseline_encode", "shrink_encode", "roi_encode", "downsample_encode",
              "gaussian_encode", "inpaint_diffusion", "sr_realesrgan", "deblur_deblur_net"]
    assert first["stage_cache"] == {"hits": [], "misses": stages}
    assert second["stage_cache"] == {"hits": stages, "misses": []}
    for row in ROWS:  # the same numbers (FVMD off: NaN in both, hence the dumps)
        second[row].pop("evaluation_seconds"), first[row].pop("evaluation_seconds")
        assert json.dumps(second[row]) == json.dumps(first[row])


def test_extra_rows_masks_dir_and_profile(tmp_path):
    """Extra backend entries add rows; external masks replace the saliency
    masks; profile_dir gets a torch.profiler trace."""
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    masks = np.zeros((4, 64, 96), np.uint8)
    masks[:, 16:48, 24:72] = 255
    (tmp_path / "masks").mkdir()
    for i, m in enumerate(masks):
        Image.fromarray(m).save(tmp_path / "masks" / f"{i:05d}.png")
    cfg = ElvisConfig(**{**CONFIG, "enable_fvmd": False, "temporal_blend": 0.1,
                         "sr_backends": ["realesrgan", "progressive_lanczos"],
                         "deblur_backends": ["deblur_net", "unsharp"],
                         "generate_opencv_benchmarks": False, "max_frames": 4,
                         "masks_dir": str(tmp_path / "masks"),
                         "profile_dir": str(tmp_path / "prof"),
                         "experiment_dir": str(tmp_path / "exp")})
    r = run_elvis(cfg, device="cpu")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    saved = np.asarray(Image.open(tmp_path / "exp" / "maps" / "saliency_masks" / "00002.png"))
    assert np.array_equal(saved[..., 0], masks[2])
    rows = [k for k, v in r.items() if isinstance(v, dict) and "foreground" in v]
    assert rows == ["Baseline", "PRESLEY QP", "ELVIS CV2", "PRESLEY RealESRGAN",
                    "PRESLEY SR progressive_lanczos", "PRESLEY InstantIR",
                    "PRESLEY Deblur unsharp"]
    assert r["PRESLEY SR progressive_lanczos"]["bitrate_mbps"] == \
        r["PRESLEY RealESRGAN"]["bitrate_mbps"]
    assert r["video_length_seconds"] == 4 / 30


def test_chunked_drivers_are_exact(monkeypatch):
    from elvis_tpu_torch.ops.filter import gaussian_blur
    from elvis_tpu_torch.pipeline import run as trun
    from elvis_tpu_torch.restore.temporal import temporal_blend
    from elvis_tpu_torch.scoring import get_saliency_fn, spatial_temporal_complexity

    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (10, 32, 48, 3)).astype(np.uint8))
    maps = torch.from_numpy(rng.integers(0, 4, (10, 4, 6)).astype(np.int32))
    sal_fn = get_saliency_fn("motion_contrast")
    one = trun._scoring_features_chunked(frames, 8, sal_fn, 16)
    three = trun._scoring_features_chunked(frames, 8, sal_fn, 3)
    cx = spatial_temporal_complexity(frames, 8)
    for a, b in zip(one[:4], three[:4]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(one[0], cx.SC, atol=1e-3, rtol=1e-5)
    assert (one[4] != three[4]).float().mean() < 1e-3

    def blur(f, m):  # a per-frame op with a 2-row receptive field
        return gaussian_blur(f.float(), 5, 1.0) + m.repeat_interleave(8, 1).repeat_interleave(
            8, 2)[..., None].float()

    blur.spatial_halo_rows = 8
    whole = blur(frames, maps)
    monkeypatch.setattr(trun, "_FRAME_CHUNK_PIXEL_BUDGET", 3 * 32 * 48)
    assert trun._chunk_frames(frames.shape) == 3
    torch.testing.assert_close(trun._apply_framewise(lambda f, m: blur(f, m), frames, maps),
                               whole)
    tiled = trun._apply_height_tiled(blur, [frames, maps], 8, 24)
    torch.testing.assert_close(tiled, whole, atol=1e-4, rtol=0)
    blend = trun._apply_temporal(lambda f: temporal_blend(f.float(), 0.1), (frames,), overlap=8)
    torch.testing.assert_close(blend, temporal_blend(frames.float(), 0.1), atol=1e-3, rtol=0)
