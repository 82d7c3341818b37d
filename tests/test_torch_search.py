"""Port parity: ``elvis_tpu_torch.search`` (the grid and random drivers, the
results pruner, the figure roll-up, the rate-distortion sweep) against
``elvis_tpu.search``.

The drivers run with ``run_elvis`` replaced in both packages by the same
fake analysis (rows whose metrics follow the overrides, an artifact and a
PNG in the run directory), so they are held to each other on: slugs and
validity, ``runs_summary.json`` (equal JSON), the pruned and renamed
layout, and the figure file names (matplotlib and pandas are installed
here), with ``minimal_figures`` on and off. One real port ``grid_search``
runs ``run_elvis`` at 4 x 48 x 32. ``rd_sweep`` against JAX's at 96 x 64,
5 frames, QP 32: each point's bits within 1%, PSNR within 0.1 dB, SSIM
within 2e-3 (the pipeline rows' tolerances).
"""

import json
import os

import numpy as np
import pytest
import torch

GRID = {"reference_video": ["synthetic://moving?frames=4"], "width": [64, 48],
        "height": [48], "block_size": [8, 16], "shrink_amount": [0.25, 0.5]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fake_run_elvis(config, device=None):
    """An analysis whose rows follow the config, with an artifact and a
    figure in the experiment directory, as a run leaves them."""
    os.makedirs(os.path.join(config.experiment_dir, "frames"), exist_ok=True)
    with open(os.path.join(config.experiment_dir, "frames", "clip.npz"), "wb") as f:
        f.write(b"x")
    with open(os.path.join(config.experiment_dir, "plot.png"), "wb") as f:
        f.write(b"png")
    base = 30.0 + config.width / 64.0 - config.block_size / 16.0

    def row(shift):
        def region(d):
            return {"psnr_mean": base + shift + d, "ssim_mean": 0.9 + shift / 100,
                    "mse_mean": 10.0 - shift, "lpips_mean": 0.1 + d / 10}

        return {"foreground": region(config.shrink_amount), "background": region(0.5),
                "bitrate_mbps": 1.0 + shift}

    return {"Baseline": row(0.0), "PRESLEY QP": row(0.4), "ELVIS CV2": row(-0.3),
            "execution_times_seconds": {"Preprocessing": 0.5, "Baseline Encoding": 1.5,
                                        "PRESLEY Restoration": 0.25, "Evaluation": 0.75},
            "video_resolution": f"{config.width}x{config.height}",
            "video_length_seconds": 0.5, "video_framerate": 8}


@pytest.fixture
def fake(monkeypatch):
    from elvis_tpu.search import grid as jgrid
    from elvis_tpu_torch.search import grid as tgrid

    monkeypatch.setattr(jgrid, "run_elvis", _fake_run_elvis)
    monkeypatch.setattr(tgrid, "run_elvis", _fake_run_elvis)


def _layout(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_slugs_and_validity_equal_jax():
    from elvis_tpu.search import grid as jgrid
    from elvis_tpu_torch.search import grid as tgrid

    cases = [{"width": 640, "height": 360, "block_size": 8},
             {"width": 640, "height": 640}, {"width": 100, "height": 64},
             {"width": 1920, "height": 816, "block_size": 16}, {"width": 0},
             {"reference_video": "a/b c.mp4", "shrink_amount": 0.25, "x": "y!z"}]
    for c in cases:
        assert tgrid.slugify(c) == jgrid.slugify(c)
        assert tgrid.is_valid_overrides(c) == jgrid.is_valid_overrides(c)
    assert tgrid.DEFAULT_PARAMETER_GRID == jgrid.DEFAULT_PARAMETER_GRID
    analysis = {"A": {"foreground": {}, "background": {}}, "B": {"foreground": {}}, "n": 3}
    assert tgrid.extract_metric_sections(analysis) == jgrid.extract_metric_sections(analysis)


@pytest.mark.parametrize("driver,minimal", [("grid", False), ("random", True)])
def test_grid_and_random_search_equal_jax(driver, minimal, fake, tmp_path):
    """The summaries (equal JSON), the run directories, the figure names
    (``minimal_figures`` read from the grid: the full set, or the core
    scatters), then the pruned layout."""
    import importlib

    from elvis_tpu.search import cleanup as jclean
    from elvis_tpu.search import grid as jgrid
    from elvis_tpu_torch.search import cleanup as tclean
    from elvis_tpu_torch.search import grid as tgrid

    # the packages' __init__ re-export the function under the module's name
    jrand = importlib.import_module("elvis_tpu.search.random_search")
    trand = importlib.import_module("elvis_tpu_torch.search.random_search")

    grid = {**GRID, "minimal_figures": [minimal]}
    for label, jrun, trun in (
            ("grid", lambda d: jgrid.grid_search(grid, d, max_runs=3),
             lambda d: tgrid.grid_search(grid, d, max_runs=3, device="cpu")),
            ("random", lambda d: jrand.random_search(grid, runs=3, seed=5, results_dir=d),
             lambda d: trand.random_search(grid, runs=3, seed=5, results_dir=d, device="cpu"))):
        if label != driver:
            continue
        jdir, tdir = str(tmp_path / f"j_{label}"), str(tmp_path / f"t_{label}")
        want, got = jrun(jdir), trun(tdir)
        assert got == want and len(got) == 3 and all(r["status"] == "ok" for r in got)
        for name in ("runs_summary.json",):
            assert json.load(open(os.path.join(tdir, name))) == json.load(
                open(os.path.join(jdir, name)))
        assert _layout(tdir) == _layout(jdir)
        figures = sorted(os.listdir(os.path.join(tdir, "figures")))
        assert figures == sorted(os.listdir(os.path.join(jdir, "figures")))
        assert ("fg_vs_bg_psnr_mean.png" in figures
                and ("parameter_correlation.png" in figures) != minimal), figures
        for slug in (r["slug"] for r in got):
            a = json.load(open(os.path.join(tdir, slug, "analysis_results.json")))
            b = json.load(open(os.path.join(jdir, slug, "analysis_results.json")))
            assert a == b
        assert tclean.cleanup_results(tdir) == jclean.cleanup_results(jdir)
        assert _layout(tdir) == _layout(jdir)
        assert not any(p.endswith(".npz") for p in _layout(tdir))


def test_a_failed_run_is_recorded_and_figures_are_best_effort(monkeypatch, tmp_path, capsys):
    """A run that raises is kept as failed (the keep-going policy), and
    without matplotlib the sweep says why its figures were skipped."""
    import builtins

    from elvis_tpu_torch.search import grid as tgrid

    def boom(config, device=None):
        raise RuntimeError("no card")

    monkeypatch.setattr(tgrid, "run_elvis", boom)
    real_import = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    out = tgrid.grid_search({**GRID, "width": [64]}, str(tmp_path), max_runs=1, device="cpu")
    assert out == [{"slug": "block_size-8_shrink_amount-0p25", "status": "failed",
                    "error": "no card", "overrides": {**{k: v[0] for k, v in GRID.items()}}}]
    printed = capsys.readouterr().out
    assert "Run block_size-8_shrink_amount-0p25 failed: no card" in printed
    # no ok run: nothing to plot, so the roll-up returns before matplotlib
    monkeypatch.setattr(tgrid, "run_elvis", _fake_run_elvis)
    tgrid.grid_search({**GRID, "width": [64]}, str(tmp_path / "b"), max_runs=1, device="cpu")
    assert "figure generation skipped: No module named 'matplotlib'" in capsys.readouterr().out


def test_one_real_port_grid_search(tmp_path):
    """``grid_search`` through the port's ``run_elvis`` at 4 x 48 x 32: the
    rows and the roll-up."""
    from elvis_tpu_torch.search import grid_search

    grid = {"reference_video": ["synthetic://moving?frames=4"], "width": [48], "height": [32],
            "enable_fvmd": [False], "enable_vmaf": [False], "target_bitrate_override": [50_000],
            "inpaint_backends": [["diffusion"]], "minimal_figures": [True]}
    out = grid_search(grid, str(tmp_path), device="cpu")
    assert len(out) == 1 and out[0]["status"] == "ok", out
    assert {"Baseline", "PRESLEY RealESRGAN", "ELVIS CV2"} <= set(out[0]["metrics"])
    assert all(np.isfinite(m["foreground"]["psnr_mean"]) for m in out[0]["metrics"].values())
    assert out[0]["num_frames"] == 4 and out[0]["video_resolution"]
    assert os.path.isfile(tmp_path / "figures" / "fg_vs_bg_psnr_mean.png")


def test_rd_sweep_equals_jax(tmp_path):
    from elvis_tpu.search.rd_curve import rd_sweep as jsweep
    from elvis_tpu_torch.search.rd_curve import plot_curves, rd_sweep

    src = "synthetic://moving?frames=5"
    want = jsweep(src, 96, 64, qps=(32,))
    got = rd_sweep(src, 96, 64, qps=(32,), out_json=str(tmp_path / "rd.json"), device="cpu")
    assert list(got) == list(want) == ["Baseline", "PRESLEY QP", "PRESLEY RealESRGAN",
                                       "PRESLEY Lanczos", "PRESLEY Unsharp"]
    for label in want:
        (g,), (w,) = got[label], want[label]
        assert g["qp"] == w["qp"] == 32
        assert abs(g["kbps"] - w["kbps"]) <= 0.01 * w["kbps"], (label, g, w)
        assert abs(g["psnr"] - w["psnr"]) <= 0.1 and abs(g["ssim"] - w["ssim"]) <= 2e-3, \
            (label, g, w)
    assert json.load(open(tmp_path / "rd.json")) == json.loads(json.dumps(got))
    plot_curves(got, str(tmp_path / "rd.png"))
    assert os.path.getsize(tmp_path / "rd.png") > 0
