"""Port parity: the PRESLEY sweep (``elvis_tpu_torch.presley``) with its
shrink methods (``degrade.shrink``) and timing helpers (``utils.timing``),
against ``elvis_tpu.presley``, ``elvis_tpu.degrade.shrink`` and
``elvis_tpu.utils.timing`` on the same numpy inputs, on the CPU.

Tolerances:
  * the shrink plans (removal masks, position maps, removal indices, shrunk
    grids) and the shrink / stretch gathers: exact;
  * ``measure_performance``'s metrics: the pipeline's row tolerances (PSNR 0.1 dB,
    SSIM 2e-3, MSE 1%, LPIPS 1e-3, FVMD 10%); measured within 1e-4 dB;
  * ``run_presley`` at 4x64x48 with ``shrink_methods=["row_only"]``: the same
    fourteen rows, every one ``ok``; each row's bytes within 1% and its
    metrics within those tolerances. The ``blur_instantir_adaptive`` row
    (the diffusion restorer, 40 DDIM steps here) draws its SDEdit noise from
    torch in the port and from ``jax.random`` in JAX (ROADMAP.md §3): it is
    held to the larger of those tolerances and twice the larger of the two
    packages' own ranges over ``instantir_seed`` 42, 43 and 44 (JAX's in
    ``JAX_SEED_RANGE``, measured; the port's measured here). Measured: SSIM
    0.6127 against JAX's 0.6016, where JAX's seeds span 0.0049 and the
    port's 0.0078; MSE 1.1% apart, JAX's seeds 0.7%, the port's 1.4%.
"""

import json

import numpy as np
import pytest
import torch

from elvis_tpu.degrade import shrink as jshrink
from elvis_tpu_torch.degrade import shrink as tshrink

ROWS = ["baseline", "shrink_row_only_telea", "shrink_row_only_propainter",
        "shrink_row_only_e2fgvi", "roi_nvc", "downsample_lanczos", "downsample_lanczos_tb",
        "downsample_realesrgan_naive", "downsample_realesrgan_adaptive",
        "downsample_scale_lanczos", "blur_unsharp", "blur_deblur_net",
        "blur_instantir_adaptive", "blur_instantir_naive"]
TOL = {"psnr": 0.1, "fg_psnr": 0.1, "bg_psnr": 0.1, "ssim": 2e-3, "lpips": 1e-3}  # absolute
RTOL = {"mse": 0.01, "fvmd": 0.10, "size_bytes": 0.01}  # relative
CLIP = dict(reference_video="synthetic://moving?frames=4", width=64, height=48, max_frames=4,
            shrink_methods=["row_only"])
SEEDS = (42, 43, 44)
# max - min of JAX's blur_instantir_adaptive metrics over SEEDS (run_presley
# at CLIP in JAX on the CPU): absolute, MSE in its own units
JAX_SEED_RANGE = {"psnr": 0.02306, "ssim": 0.004939, "mse": 0.8525, "fg_psnr": 0.03682,
                  "bg_psnr": 0.03412}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("method", ["row_only", "row_col"])
@pytest.mark.parametrize("grid,amount", [((6, 8), 0.25), ((9, 16), 0.4), ((5, 5), 0.9)])
def test_plan_shrink_equals_jax(method, grid, amount):
    """The greedy replay: the row-only method, and the row/column schedule
    that the position-map and removal-indices methods share."""
    imp = np.random.default_rng(grid[0] * 31 + grid[1]).random(grid)
    imp[0, :3] = imp[0, 3]  # ties: argmin takes the first in both
    j, t = jshrink.plan_shrink(imp, amount, method), tshrink.plan_shrink(imp, amount, method)
    np.testing.assert_array_equal(t.removal_mask, j.removal_mask)
    np.testing.assert_array_equal(t.position_map, j.position_map)
    assert t.shrunk_grid == j.shrunk_grid and t.position_map.dtype == np.int32
    assert len(t.removal_indices) == len(j.removal_indices)
    for a, b in zip(t.removal_indices, j.removal_indices):
        np.testing.assert_array_equal(a, b)
    assert int(t.removal_mask.sum()) <= int(grid[0] * grid[1] * amount)


def test_plan_shrink_unknown_method_raises_in_both():
    for mod in (jshrink, tshrink):
        with pytest.raises(ValueError, match="unknown shrink method 'columns'"):
            mod.plan_shrink(np.ones((4, 4)), 0.25, "columns")


@pytest.mark.parametrize("method", ["row_only", "row_col"])
def test_shrink_and_stretch_video_exact(method):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    imp = rng.random((3, 6, 8))
    js, jplans = jshrink.shrink_video(jnp.asarray(frames), imp, 8, 0.3, method)
    ts, tplans = tshrink.shrink_video(torch.from_numpy(frames), imp, 8, 0.3, method)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back_j = np.asarray(jshrink.stretch_video(js, jplans, 8))
    back_t = tshrink.stretch_video(ts, tplans, 8).numpy()
    np.testing.assert_array_equal(back_t, back_j)
    one = tshrink.shrink_frame(torch.from_numpy(frames[1]), tplans[1], 8)
    np.testing.assert_array_equal(one.numpy(), ts[1].numpy())
    np.testing.assert_array_equal(tshrink.stretch_frame(one, tplans[1], 8).numpy(), back_t[1])


def _clip(n=6, h=48, w=64):
    from elvis_tpu_torch.pipeline.io import synthetic_clip

    return synthetic_clip("moving", frames=n, height=h, width=w, seed=0)


def test_measure_performance_keys_and_metrics_equal_jax():
    from elvis_tpu.utils import measure_performance as jmeasure
    from elvis_tpu_torch.utils import measure_performance as tmeasure

    ref = _clip()
    dec = np.clip(ref.astype(np.int16) + np.random.default_rng(1).integers(-9, 10, ref.shape),
                  0, 255).astype(np.uint8)
    fg = np.zeros(ref.shape[:3], bool)
    fg[:, 8:30, 10:40] = True
    kw = dict(reference_frames=ref, fg_masks=fg, label="row", exclude=())
    j = jmeasure(lambda f: dec, ref, **kw)
    t = tmeasure(lambda f: torch.from_numpy(dec), torch.from_numpy(ref), **kw)
    assert sorted(t) == sorted(j) == ["fps", "frames", "label", "metrics", "output", "seconds",
                                      "status"]
    assert (t["status"], t["frames"], t["label"]) == (j["status"], j["frames"], j["label"])
    assert sorted(t["metrics"]) == sorted(j["metrics"]) == [
        "bg_psnr", "fg_psnr", "fvmd", "lpips", "mse", "psnr", "ssim"]
    _metrics_close(t["metrics"], j["metrics"])
    # an error is a row, not an exception: status "error" with its text
    for fn in (jmeasure, tmeasure):
        rec = fn(lambda f: 1 / 0, ref[:2], label="bad")
        assert rec["status"] == "error" and rec["fps"] == 0.0
        assert rec["error"].startswith("ZeroDivisionError") and "metrics" not in rec
    assert sorted(tmeasure(lambda f: f, torch.from_numpy(ref), reference_frames=ref)["metrics"]) \
        == ["mse", "psnr", "ssim"]


def test_measure_time_and_console_helpers(tmp_path, capsys):
    from elvis_tpu_torch.utils import measure_time, safe_print, silence_console_output

    log = tmp_path / "t" / "log.jsonl"

    @measure_time("work", log_path=str(log))
    def work(x):
        return x * 2

    @measure_time(log_path=str(log))
    def boom():
        raise KeyError("k")

    assert work(3) == 6
    with pytest.raises(KeyError):
        boom()
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [(r["name"], r["status"]) for r in recs] == [("work", "ok"), ("boom", "error")]
    with silence_console_output():
        print("hidden")
    safe_print("shown")
    assert capsys.readouterr().out.splitlines()[-1] == "shown"


def test_presley_config_and_argparse_equal_jax():
    import dataclasses

    from elvis_tpu import presley as jp
    from elvis_tpu_torch import presley as tp

    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jp.PresleyConfig)]
    assert [(f.name, str(f.type)) for f in dataclasses.fields(tp.PresleyConfig)] == jf
    assert dataclasses.asdict(tp.PresleyConfig()) == dataclasses.asdict(jp.PresleyConfig())
    for argv in ([], ["--width", "320", "--save_intermediate", "--quality", "low"],
                 ["--shrink_methods", '["row_col"]', "--metrics_to_exclude", "fvmd,lpips",
                  "--framerate", "25", "--realesrgan_fp32"]):
        t = tp.parse_and_update_config(tp.PresleyConfig(), list(argv))
        j = jp.parse_and_update_config(jp.PresleyConfig(), list(argv))
        assert dataclasses.asdict(t) == dataclasses.asdict(j), argv


def test_run_presley_refuses_a_missing_card(tmp_path, monkeypatch):
    from elvis_tpu_torch import presley as tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.main(["--output_dir", str(tmp_path / "out")])


def _metrics_close(t, j, spread=None):
    for key, tol in TOL.items():
        if key in j:
            bound = max(tol, 2 * spread[key]) if spread else tol
            assert abs(t[key] - j[key]) <= bound, (key, t[key], j[key])
    for key in ("mse", "fvmd"):
        if key in j:
            bound = max(RTOL[key], 2 * spread[key] / j[key]) if spread else RTOL[key]
            assert abs(t[key] - j[key]) <= bound * j[key], (key, t[key], j[key])
    assert all(np.isfinite(v) for v in t.values())


@pytest.fixture(scope="module")
def presley_runs(tmp_path_factory):
    from elvis_tpu import presley as jp
    from elvis_tpu_torch import presley as tp

    out = {}
    for seed in SEEDS:  # the port's own seed range for the diffusion row
        cfg = tp.PresleyConfig(output_dir=str(tmp_path_factory.mktemp(f"t{seed}")),
                               instantir_seed=seed, **CLIP)
        out[seed] = tp.run_presley(cfg, device="cpu")
    out["jax"] = jp.run_presley(jp.PresleyConfig(output_dir=str(tmp_path_factory.mktemp("j")),
                                                 **CLIP))
    out["dir"] = cfg.output_dir
    return out


def test_run_presley_rows_equal_jax(presley_runs):
    t, j = presley_runs[42], presley_runs["jax"]
    assert list(t["methods"]) == list(j["methods"]) == ROWS
    assert t["config"]["output_dir"] != j["config"]["output_dir"]
    assert {k: v for k, v in t["config"].items() if k != "output_dir"} == \
        {k: v for k, v in j["config"].items() if k != "output_dir"}
    for row in ROWS:
        a, b = t["methods"][row], j["methods"][row]
        assert a["status"] == b["status"] == "ok", (row, a.get("error"))
        assert sorted(a) == sorted(b), row
        assert abs(a["size_bytes"] - b["size_bytes"]) <= RTOL["size_bytes"] * b["size_bytes"]
        spread = None
        if row == "blur_instantir_adaptive":
            seeds = [presley_runs[s]["methods"][row]["metrics"] for s in SEEDS]
            spread = {k: max(JAX_SEED_RANGE[k],
                             max(m[k] for m in seeds) - min(m[k] for m in seeds))
                      for k in JAX_SEED_RANGE}
        _metrics_close(a["metrics"], b["metrics"], spread)


def test_run_presley_writes_its_json_and_frames(presley_runs):
    import os

    out = presley_runs["dir"]
    with open(os.path.join(out, "performance_metrics.json")) as f:
        saved = json.load(f)
    assert list(saved["methods"]) == ROWS
    assert sorted(os.listdir(os.path.join(out, "roi_nvc"))) == [f"{i:05d}.png"
                                                                 for i in range(1, 5)]
