"""Port parity: the blur branch and the classical rows as a whole, on a
4x64x96 clip on the CPU (elvis_tpu_torch against elvis_tpu, each side from
its own scores): scoring -> ``adaptive_blur`` -> ``resolve_deblur_backend``
('deblur_net' = the committed DeblurUNet, and 'unsharp'), and
``adaptive_downsample`` -> ``restore_downsample_lanczos``.

Tolerances: rounds and level maps equal; uint8 outputs of the classical
rows at most 1 LSB apart and their masked PSNR per frame within 0.01 dB.
The net is held twice. In float32 on both sides (the committed weights)
its PSNR per frame is within 0.01 dB: that is the check of the port. In
its default bf16 body the two frameworks round the conv sums at different
places, and this net turns that into 0.7 grey levels of mean difference
on such a clip (tests/test_torch_deblur.py): the clip's mean PSNR is held
within 0.05 dB and each frame within 0.1 dB (measured: 0.007 dB and
0.064 dB), and the foreground PSNR, a mean over a few hundred pixels of a
frame, within 0.25 dB per frame (measured: 0.176 dB). JAX's own bf16 model
is as far from its float32 model (up to 0.15 dB per frame over all pixels
on clips of this kind), so a tighter bar would test the rounding, not the
port.
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.degrade import adaptive as jadaptive
from elvis_tpu.metrics import pixel as jpixel
from elvis_tpu.models import DeblurUNet as JDeblurUNet
from elvis_tpu.models.io import load_params
from elvis_tpu.pipeline.config import ElvisConfig as JConfig
from elvis_tpu.restore.backends import resolve_deblur_backend as jresolve
from elvis_tpu.restore.lanczos import restore_downsample_lanczos as jlanczos
from elvis_tpu.scoring import complexity as jcomplexity
from elvis_tpu.scoring import fusion as jfusion
from elvis_tpu.scoring import saliency as jsaliency
from elvis_tpu.utils.transfer import as_pixels_u8
from elvis_tpu_torch.degrade import adaptive as tadaptive
from elvis_tpu_torch.metrics import pixel as tpixel
from elvis_tpu_torch.models.io import load_deblur, weights_path
from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig
from elvis_tpu_torch.restore import restore_downsample_lanczos as tlanczos
from elvis_tpu_torch.restore.backends import resolve_deblur_backend as tresolve
from elvis_tpu_torch.scoring import complexity as tcomplexity
from elvis_tpu_torch.scoring import fusion as tfusion
from elvis_tpu_torch.scoring import saliency as tsaliency

B = 8
CLASSICAL_TOL_DB = 0.01
NET_F32_TOL_DB = 0.01
NET_BF16_CLIP_TOL_DB = 0.05
NET_BF16_FRAME_TOL_DB = 0.1
NET_BF16_FG_FRAME_TOL_DB = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def clip():
    """(4, 64, 96, 3) uint8: moving gradients plus noise, from a numpy seed."""
    rng = np.random.default_rng(0)
    n, h, w = 4, 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        base = 128 + 60 * np.sin(2 * np.pi * (xx + 7 * t) / 32) + 40 * np.cos(2 * np.pi * yy / 24)
        img = np.stack([base, np.roll(base, 3, axis=1), np.roll(base, -2, axis=0)], axis=-1)
        frames.append(np.clip(img + rng.normal(0, 6, size=img.shape), 0, 255))
    return np.stack(frames).astype(np.uint8)


def _np(x):
    """A writable host array of a tensor or a JAX array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.fixture(scope="module")
def jax_side(clip):
    cfg = JConfig()
    x = jnp.asarray(clip)
    cx = jcomplexity.spatial_temporal_complexity(x, B)
    sal = jsaliency.motion_contrast_saliency(x)
    scores = jfusion.removability_scores(cx.SC, cx.TC, jsaliency.saliency_to_block_mask(sal, B))
    blurred, rounds = jadaptive.adaptive_blur(x, scores, B, cfg.gaussian_max_rounds)
    degraded, levels = jadaptive.adaptive_downsample(x, scores, B)
    out = {"rounds": _np(rounds), "levels": _np(levels), "blurred": _np(blurred),
           "fg": _np(sal >= 0.5), "prov": {}}
    for name in ("deblur_net", "unsharp"):
        fn, out["prov"][name] = jresolve(name, cfg)
        out[name] = _np(as_pixels_u8(fn)(blurred, rounds, B))
    out["lanczos"] = _np(jlanczos(degraded, levels, B))
    for row in ("blurred", "deblur_net", "unsharp", "lanczos"):
        out[f"psnr_{row}"] = _np(jpixel.masked_psnr(x, jnp.asarray(out[row])))
        out[f"psnr_fg_{row}"] = _np(jpixel.masked_psnr(x, jnp.asarray(out[row]), sal >= 0.5))
    return out


@pytest.fixture(scope="module")
def torch_side(clip):
    cfg = TConfig()
    x = torch.from_numpy(clip)
    cx = tcomplexity.spatial_temporal_complexity(x, B)
    sal = tsaliency.motion_contrast_saliency(x)
    scores = tfusion.removability_scores(cx.SC, cx.TC, tsaliency.saliency_to_block_mask(sal, B))
    blurred, rounds = tadaptive.adaptive_blur(x, scores, B, cfg.gaussian_max_rounds)
    degraded, levels = tadaptive.adaptive_downsample(x, scores, B)
    out = {"rounds": _np(rounds), "levels": _np(levels), "blurred": _np(blurred),
           "fg": _np(sal >= 0.5), "prov": {}}
    for name in cfg.deblur_backends + ["unsharp"]:
        fn, out["prov"][name] = tresolve(name, cfg, device="cpu")
        out[name] = _np(fn(blurred, rounds, B))
    out["lanczos"] = _np(tlanczos(degraded, levels, B))
    for row in ("blurred", "deblur_net", "unsharp", "lanczos"):
        y = torch.from_numpy(out[row])
        out[f"psnr_{row}"] = _np(tpixel.masked_psnr(x, y))
        out[f"psnr_fg_{row}"] = _np(tpixel.masked_psnr(x, y, sal >= 0.5))
    return out


def test_maps_and_blurred_frames_match(jax_side, torch_side):
    np.testing.assert_array_equal(torch_side["rounds"], jax_side["rounds"])
    np.testing.assert_array_equal(torch_side["levels"], jax_side["levels"])
    np.testing.assert_array_equal(torch_side["fg"], jax_side["fg"])
    assert jax_side["rounds"].max() >= 5 and jax_side["rounds"].min() == 0
    diff = np.abs(torch_side["blurred"].astype(int) - jax_side["blurred"].astype(int))
    assert diff.max() <= 1
    np.testing.assert_allclose(torch_side["psnr_blurred"], jax_side["psnr_blurred"],
                               atol=CLASSICAL_TOL_DB)


@pytest.mark.parametrize("row", ["unsharp", "lanczos"])
def test_classical_rows_match(jax_side, torch_side, row):
    got, want = torch_side[row], jax_side[row]
    assert got.dtype == np.uint8 and got.shape == want.shape == (4, 64, 96, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    for key in (f"psnr_{row}", f"psnr_fg_{row}"):
        assert np.isfinite(torch_side[key]).all()
        np.testing.assert_allclose(torch_side[key], jax_side[key], atol=CLASSICAL_TOL_DB,
                                   err_msg=key)


def test_deblur_net_row_matches(jax_side, torch_side):
    got, want = torch_side["deblur_net"], jax_side["deblur_net"]
    assert got.dtype == np.uint8 and got.shape == want.shape == (4, 64, 96, 3)
    got_p, want_p = torch_side["psnr_deblur_net"], jax_side["psnr_deblur_net"]
    np.testing.assert_allclose(got_p, want_p, atol=NET_BF16_FRAME_TOL_DB)
    assert abs(got_p.mean() - want_p.mean()) <= NET_BF16_CLIP_TOL_DB
    np.testing.assert_allclose(torch_side["psnr_fg_deblur_net"], jax_side["psnr_fg_deblur_net"],
                               atol=NET_BF16_FG_FRAME_TOL_DB)
    # the net ran: not the unsharp row, and not the blurred input
    assert np.abs(got.astype(int) - torch_side["unsharp"].astype(int)).max() > 0
    assert np.abs(got.astype(int) - torch_side["blurred"].astype(int)).max() > 0


def test_deblur_net_row_matches_in_float32(clip, jax_side, torch_side):
    """The committed weights in float32 on both sides, on the blurred clip."""
    from pathlib import Path

    ckpt = str(Path(__file__).resolve().parents[1] / "checkpoints" / "deblur")
    jm = JDeblurUNet(dtype=jnp.float32, max_strength=10.0)
    params = load_params(jm, ckpt, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 2, 2), jnp.int32), 8)
    blurred, rounds = jax_side["blurred"], jax_side["rounds"]
    want = _np(jm.apply(params, jnp.asarray(blurred, jnp.float32), jnp.asarray(rounds), B))
    tm = load_deblur(weights_path("deblur"), device="cpu")
    tm.dtype = torch.float32
    with torch.no_grad():
        got = _np(tm(torch.from_numpy(blurred), torch.from_numpy(rounds), B))
    np.testing.assert_allclose(got, want, atol=1e-3)
    x = torch.from_numpy(clip)
    p_got = _np(tpixel.masked_psnr(x, torch.from_numpy(got)))
    p_want = _np(jpixel.masked_psnr(jnp.asarray(clip), jnp.asarray(want)))
    np.testing.assert_allclose(p_got, p_want, atol=NET_F32_TOL_DB)
    fg = jax_side["fg"]
    np.testing.assert_allclose(
        _np(tpixel.masked_psnr(x, torch.from_numpy(got), torch.from_numpy(fg))),
        _np(jpixel.masked_psnr(jnp.asarray(clip), jnp.asarray(want), jnp.asarray(fg))),
        atol=NET_F32_TOL_DB)
    # and the net helps: above the blurred input on every frame
    assert (p_got > torch_side["psnr_blurred"]).all()


def test_provenance_strings(jax_side, torch_side):
    assert torch_side["prov"]["unsharp"] == jax_side["prov"]["unsharp"] == "unsharp"
    assert jax_side["prov"]["deblur_net"].startswith("deblur_net:")
    assert torch_side["prov"]["deblur_net"].startswith("deblur_net:")
    assert torch_side["prov"]["deblur_net"].endswith("deblur.npz")


@pytest.mark.parametrize("name", ["deblur_net", "neural", "instantir"])
def test_missing_weights_fall_back_to_unsharp_by_name(torch_side, name, tmp_path):
    """Without a weights file the net's slot is the unsharp mask, and the
    provenance says so, as in the JAX package."""
    for cfg in (TConfig(deblur_params_path=str(tmp_path / "nope.npz")),
                TConfig(auto_load_checkpoints=False)):
        fn, prov = tresolve(name, cfg, device="cpu")
        assert prov == "unsharp (no deblur checkpoint)"
        got = fn(torch.from_numpy(torch_side["blurred"]), torch.from_numpy(torch_side["rounds"]), B)
        np.testing.assert_array_equal(_np(got), torch_side["unsharp"])
    _, jprov = jresolve(name, JConfig(auto_load_checkpoints=False))
    assert jprov == "unsharp (no deblur checkpoint)"


def test_backend_knobs_and_frame_chunks(torch_side):
    """The net runs in frame chunks bounded by its pixel budget and by
    ``instantir_parallel_chunk_length``; chunking does not change a pixel."""
    fn, _ = tresolve("deblur_net", TConfig(), device="cpu")
    assert (fn.spatial_halo_rows, fn.spatial_pixel_budget) == (64, 3 << 20)
    assert not hasattr(fn, "frame_chunk")
    fn1, _ = tresolve("deblur_net", TConfig(instantir_parallel_chunk_length=1), device="cpu")
    assert fn1.frame_chunk == 1
    f, m = torch.from_numpy(torch_side["blurred"]), torch.from_numpy(torch_side["rounds"])
    np.testing.assert_array_equal(_np(fn1(f, m, B)), torch_side["deblur_net"])
    fn.spatial_pixel_budget = 64 * 96  # one frame per call
    np.testing.assert_array_equal(_np(fn(f, m, B)), torch_side["deblur_net"])
    out32 = fn(f.float(), m, B)
    assert out32.dtype == torch.float32  # float in, float out (not rounded)
    unsharp, _ = tresolve("unsharp", TConfig(instantir_parallel_chunk_length=2), device="cpu")
    assert unsharp.frame_chunk == 2


@pytest.mark.parametrize("name", ["diffusion", "naive_diffusion"])
def test_diffusion_backends_say_they_are_not_ported(name):
    """Both names are ported now (they raised "not ported yet" before): each
    resolves with the JAX package's provenance, the weights file in place
    of the checkpoint directory, and its frames a call; without weights
    'diffusion' degrades to the unsharp mask under JAX's provenance."""
    for kw in ({"instantir_parallel_chunk_length": 3}, {"instantir_batch_size": 2},
               {"auto_load_checkpoints": False}):
        t_fn, t_prov = tresolve(name, TConfig(**kw), device="cpu")
        j_fn, j_prov = jresolve(name, JConfig(**kw))
        assert t_prov == re.sub(r"/checkpoints/(\w+)", r"/elvis_tpu_torch/weights/\1.npz",
                                j_prov), kw
        assert getattr(t_fn, "frame_chunk", None) == getattr(j_fn, "frame_chunk", None), kw


def test_unknown_backend_and_missing_card():
    with pytest.raises(ValueError, match="unknown deblur backend"):
        tresolve("nope", TConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tresolve("deblur_net", TConfig())


def test_config_fields_match_the_jax_defaults():
    j, t = JConfig(), TConfig()
    for name in ("deblur_backends", "gaussian_max_rounds", "deblur_params_path",
                 "generate_opencv_benchmarks", "instantir_parallel_chunk_length"):
        assert getattr(t, name) == getattr(j, name), name
