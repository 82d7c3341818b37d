"""Port parity: the evaluation stage -- LPIPS (``metrics.perceptual``), FVMD
(``metrics.fvmd``), VMAF's wrapper, the per-approach fan-out
(``metrics.evaluate``), the report and the block SSIM -- against
``elvis_tpu``, the JAX side as the pipeline runs it (FVMD features from its
jitted extractor).

Tolerances: LPIPS on the shipped backbone within 1e-5 relative (float32
convs, no TF32). FVMD features EXACT: the histogram edges are the nine
float32 values the jitted ``jnp.linspace`` gives (checked bit for bit), and
integer motion lands on the same bins, diagonals on the angle edges
included; the Frechet fit is the same float64 numpy code, so equal inputs
give equal FVMD. Per-approach dicts: the same keys at every depth; PSNR
within 1e-4 dB, MSE within 1e-3 relative, SSIM within 1e-5, LPIPS within
1e-5 relative (the pixel metrics are float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu.metrics import block_ssim as jbs
from elvis_tpu.metrics import evaluate as jev
from elvis_tpu.metrics import fvmd as jfv
from elvis_tpu.metrics import report as jrep
from elvis_tpu.metrics import vmaf as jvm
from elvis_tpu.metrics.perceptual import lpips_distance as jlpips
from elvis_tpu_torch.metrics import block_ssim as tbs
from elvis_tpu_torch.metrics import evaluate as tev
from elvis_tpu_torch.metrics import fvmd as tfv
from elvis_tpu_torch.metrics import report as trep
from elvis_tpu_torch.metrics import vmaf as tvm
from elvis_tpu_torch.metrics.perceptual import PerceptualNet, _same_pad, lpips_distance as tlpips

LPIPS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clip(n=6, h=64, w=96, step=(1, 1), seed=0, obj=True):
    """A textured pan with a foreground square moving against it."""
    rng = np.random.default_rng(seed)
    pad = 3 * n
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad]
    tex = 120 + 50 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + 20 * np.sin((xx + yy) / 3.0)
    frames, masks = [], []
    for t in range(n):
        y0, x0 = pad - t * step[0], pad - t * step[1]
        f = tex[y0:y0 + h, x0:x0 + w].copy()
        m = np.zeros((h, w), bool)
        if obj:
            cy, cx = h // 3 + t, w // 3 + 2 * t
            m[cy:cy + 20, cx:cx + 24] = True
            f[m] = 220 - 30 * np.cos(xx[:h, :w][m] / 3.0)
        frames.append(np.stack([f, f * 0.9, f * 1.05], -1) + rng.normal(0, 2, (h, w, 3)))
        masks.append(m)
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8), np.stack(masks)


def _degraded(frames, seed=1, sigma=6.0):
    rng = np.random.default_rng(seed)
    return np.clip(frames + rng.normal(0, sigma, frames.shape), 0, 255).astype(np.uint8)


def test_same_padding_is_flax_uneven():
    assert _same_pad(64, 7, 2) == (2, 3) and _same_pad(37, 5, 2) == (2, 2)
    assert _same_pad(8, 3, 1) == (1, 1)
    net = PerceptualNet()
    shapes = [tuple(f.shape) for f in net(torch.zeros((1, 37, 50, 3)))]
    assert shapes == [(1, 32, 19, 25), (1, 64, 10, 13), (1, 128, 5, 7), (1, 128, 5, 7),
                      (1, 128, 5, 7)]


@pytest.mark.parametrize("h,w", [(64, 96), (37, 50), (18, 30)])
def test_lpips_distance_on_shipped_weights(h, w):
    ref, _ = _clip(n=3, h=h, w=w)
    dec = _degraded(ref)
    j = np.asarray(jlpips(jnp.asarray(ref.astype(np.float32)), jnp.asarray(dec.astype(np.float32))))
    t = _np(tlpips(torch.from_numpy(ref.astype(np.float32)), torch.from_numpy(dec.astype(np.float32))))
    assert (j > 0).all()
    np.testing.assert_allclose(t, j, rtol=LPIPS_RTOL, atol=0)


@pytest.mark.parametrize("start,stop", [(-np.pi, np.pi), (0.0, 33.0), (0.0, 22.0)])
def test_hist_edges_bit_for_bit(start, stop):
    """The jitted extractor's edges (XLA folds the constant linspace)."""
    want = np.asarray(jax.jit(lambda: jnp.linspace(start, stop, 9))())
    got = tfv.hist_edges(start, stop, 8)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))


def test_unit_directions_land_in_jax_bins():
    dirs = np.array([(dy, dx) for dy in (-2, -1, 0, 1, 2) for dx in (-2, -1, 0, 1, 2)],
                    np.float32)

    def jbins(f):
        ang = jnp.arctan2(f[..., 0], f[..., 1])
        edges = jnp.linspace(-np.pi, np.pi, 9)
        return jnp.clip(jnp.searchsorted(edges, ang, side="right") - 1, 0, 7)

    j = np.asarray(jax.jit(jbins)(jnp.asarray(dirs)))
    f = torch.from_numpy(dirs)
    t = torch.clamp(torch.searchsorted(torch.from_numpy(tfv.hist_edges(-np.pi, np.pi, 8)),
                                       torch.atan2(f[:, 0], f[:, 1]), right=True) - 1, 0, 7)
    assert np.array_equal(_np(t), j)
    # torch.linspace's own edges would move some of these vectors
    t_lin = torch.clamp(torch.searchsorted(torch.linspace(-np.pi, np.pi, 9),
                                           torch.atan2(f[:, 0], f[:, 1]), right=True) - 1, 0, 7)
    assert not np.array_equal(_np(t_lin), j)


@pytest.mark.parametrize("step", [(1, 1), (-1, 0), (2, -2), (0, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_motion_features_exact(step, masked):
    frames, masks = _clip(n=6, step=step)
    jfn = jfv._jitted_features(16, 4, masked, False)
    args = (jnp.asarray(frames),) + ((jnp.asarray(masks),) if masked else ())
    j = np.asarray(jfn(*args))
    t = _np(tfv.motion_features(torch.from_numpy(frames), 16, 4,
                                mask=torch.from_numpy(masks).float() if masked else None))
    assert t.shape == (4, 32) and np.array_equal(t, j)


def test_region_features_and_fvmd_exact():
    ref, masks = _clip(n=7, step=(1, 2))
    dec = _degraded(ref, sigma=12.0)
    jr = jfv.region_motion_features(ref, masks)
    tr = tfv.region_motion_features(torch.from_numpy(ref), torch.from_numpy(masks))
    jd = jfv.region_motion_features(dec, masks, stride=1)
    td = tfv.region_motion_features(torch.from_numpy(dec), torch.from_numpy(masks))
    for a, b in zip(tr + td, jr + jd):
        assert np.array_equal(a, b)
    for kw in (dict(), dict(early_stop_delta=0.5, window=2)):
        assert tfv.fvmd_from_features(tr[0], td[0], **kw) == jfv.fvmd_from_features(jr[0], jd[0],
                                                                                     **kw)
    assert tfv.frechet_distance(tr[1], td[1]) == jfv.frechet_distance(jr[1], jd[1])
    assert tfv.fvmd(torch.from_numpy(ref), torch.from_numpy(dec)) == jfv.fvmd(ref, dec)
    assert tfv.fvmd_incremental(torch.from_numpy(ref), torch.from_numpy(dec),
                                mask=torch.from_numpy(masks), max_frames=6) == \
        jfv.fvmd_incremental(ref, dec, mask=masks.astype(np.float32), max_frames=6)
    assert tfv.region_motion_features(torch.from_numpy(ref[:3]), torch.from_numpy(masks[:3])) \
        == (None, None)


def test_chunk_spans_overlap_exactly():
    """Long clips run in 16-frame spans overlapping by 2: the concatenation
    is the one-shot extraction."""
    ref, masks = _clip(n=20, h=48, w=64, step=(1, 1), obj=False)
    assert list(tfv._chunk_spans(20, 16)) == list(jfv._chunk_spans(20, 16))
    one = _np(tfv.motion_features(torch.from_numpy(ref), 16, 4))
    chunked = tfv._features_chunked(torch.from_numpy(ref), None, 16, 4)
    assert np.array_equal(chunked, one)


def _assert_result_close(t, j, path=""):
    assert isinstance(t, dict) == isinstance(j, dict), path
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for k in j:
            _assert_result_close(t[k], j[k], f"{path}/{k}")
        return
    if path.endswith("evaluation_seconds"):
        return
    if np.isnan(j):
        assert np.isnan(t), path
    elif "psnr" in path:
        assert abs(t - j) <= 1e-4, path
    elif "ssim" in path:
        assert abs(t - j) <= 1e-5, path
    elif "fvmd" in path or "bitrate" in path:
        assert t == j, path
    else:  # mse, lpips
        assert abs(t - j) <= 1e-3 * abs(j) + 1e-9, path


@pytest.mark.parametrize("stride,fvmd_on", [(1, True), (2, False)])
def test_evaluate_approach_dicts_match(stride, fvmd_on):
    ref, masks = _clip(n=6)
    dec = _degraded(ref)
    kw = dict(metric_stride=stride, enable_fvmd=fvmd_on, enable_vmaf=False)
    j = jev.evaluate_approach(ref, dec, masks, 123456.0, **kw)
    t = tev.evaluate_approach(torch.from_numpy(ref), torch.from_numpy(dec),
                              torch.from_numpy(masks), 123456.0, **kw)
    _assert_result_close(t, j)
    assert np.isfinite(t["foreground"]["lpips_mean"]) and t["bitrate_mbps"] == 0.123456


def test_analyze_encoding_performance_matches():
    ref, masks = _clip(n=5)
    decoded = {"Baseline": _degraded(ref, 1), "PRESLEY QP": _degraded(ref, 2, 9.0)}
    rates = {"Baseline": 1e5, "PRESLEY QP": 2e5}
    j = jev.analyze_encoding_performance(ref, dict(decoded), masks, rates, enable_vmaf=False,
                                         analysis_sample_frames=4)
    t_dec = {k: torch.from_numpy(v) for k, v in decoded.items()}
    t = tev.analyze_encoding_performance(torch.from_numpy(ref), t_dec, torch.from_numpy(masks),
                                         rates, enable_vmaf=False, analysis_sample_frames=4,
                                         consume=True)
    assert t_dec == {}  # consumed
    _assert_result_close(t, j)
    assert trep.format_summary_report(j) == jrep.format_summary_report(j)
    assert trep.format_summary_report(t).splitlines()[0] == jrep.format_summary_report(j).splitlines()[0]


@pytest.mark.parametrize("results", [
    {},
    {"A": {"foreground": {"psnr_mean": 30.0, "fvmd": float("nan")}, "background": {},
           "bitrate_mbps": 0.5}},
    {"Baseline": {"foreground": {"psnr_mean": 31.25, "ssim_mean": 0.9, "mse_mean": 12.0,
                                 "lpips_mean": 0.01, "fvmd": 2.5},
                  "background": {"psnr_mean": 35.5}, "bitrate_mbps": 1.0},
     "B": {"foreground": {"psnr_mean": 29.0, "ssim_mean": 0.95, "mse_mean": 0.0,
                          "lpips_mean": 0.02, "fvmd": float("nan")},
           "background": {"psnr_mean": 36.0}, "bitrate_mbps": 0.75},
     "video_name": "x"},
])
def test_format_summary_report_equal_strings(results):
    assert trep.format_summary_report(results) == jrep.format_summary_report(results)


def test_block_ssim_matches():
    ref, masks = _clip(n=3)
    dec = _degraded(ref, sigma=10.0)
    for b in (8, 16):
        j = np.asarray(jbs.block_ssim_map(jnp.asarray(ref), jnp.asarray(dec), b))
        t = _np(tbs.block_ssim_map(torch.from_numpy(ref), torch.from_numpy(dec), b))
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
        jo = [float(x) for x in jbs.fg_bg_ssim(jnp.asarray(ref), jnp.asarray(dec),
                                               jnp.asarray(masks), b)]
        to = [float(x) for x in tbs.fg_bg_ssim(torch.from_numpy(ref), torch.from_numpy(dec),
                                               torch.from_numpy(masks), b)]
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)


def test_vmaf_wrapper_without_binary(monkeypatch):
    assert tvm.vmaf_available() == jvm.vmaf_available()
    monkeypatch.setattr(tvm, "_vmaf_binary", lambda: None)
    out = tvm.compute_vmaf(np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 8, 8, 3), np.uint8))
    assert list(out) == ["mean", "min", "harmonic_mean"] and all(np.isnan(v) for v in out.values())


def test_missing_lpips_weights_raise(monkeypatch):
    """Intended divergence: without its checkpoint the JAX package falls
    back to random features from PRNGKey(1234), which the port cannot draw;
    the port raises instead."""
    from elvis_tpu_torch.metrics import perceptual as tper
    from elvis_tpu_torch.models import io as tio

    monkeypatch.setattr(tper, "_models", {})
    monkeypatch.setattr(tio, "weights_path", lambda name: None)
    with pytest.raises(FileNotFoundError, match="perceptual.npz"):
        tper.ensure_loaded("cpu")


def test_vmaf_rows_with_a_binary(tmp_path, monkeypatch):
    """Where a vmaf binary exists the port adds the three VMAF keys. The JAX
    package's evaluate_approach reads an unbound crop box there (NameError);
    the port unpacks the foreground bbox."""
    import stat

    fake = tmp_path / "vmaf"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = --output ] && out=$2; shift; "
                    "done\necho '{\"pooled_metrics\": {\"vmaf\": {\"mean\": 90.5, \"min\": 80, "
                    "\"harmonic_mean\": 90}}}' > \"$out\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tvm, "_vmaf_binary", lambda: str(fake))
    monkeypatch.setattr(jvm, "_vmaf_binary", lambda: str(fake))
    ref, masks = _clip(n=4)
    dec = _degraded(ref)
    t = tev.evaluate_approach(torch.from_numpy(ref), torch.from_numpy(dec),
                              torch.from_numpy(masks), 1e5, enable_fvmd=False)
    assert t["foreground"]["vmaf"] == t["background"]["vmaf"] == 90.5
    assert t["vmaf"] == {"mean": 90.5, "min": 80.0, "harmonic_mean": 90.0}
    with pytest.raises(NameError):
        jev.evaluate_approach(ref, dec, masks, 1e5, enable_fvmd=False)
