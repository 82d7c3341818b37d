"""Port parity: the whole first slice, scoring -> adaptive downsample ->
progressive SR -> masked metrics, on ``tiny_video`` (elvis_tpu_torch
against elvis_tpu, each side from its own scores, on the CPU); and the same
slice through the NVC codec and the strength-map sidecar, as the pipeline's
downsample branch runs it.

Tolerance: the restored clip's masked PSNR agrees with the JAX run within
0.01 dB, per frame. The net is a narrow random-weight SRNetCompact in its
default bf16 trunk, so single bf16 rounding differences between the two
frameworks reach the output (see tests/test_torch_srnet.py); averaged over
a frame's pixels they move PSNR by well under 0.01 dB.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elvis_tpu.pipeline.config import ElvisConfig as JConfig
from elvis_tpu.restore.backends import resolve_sr_backend as jresolve
from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig
from elvis_tpu_torch.restore.backends import resolve_sr_backend as tresolve
from elvis_tpu_torch.restore.registry import available_restorers, get_restorer

(jadaptive, jcomplexity, jfusion, jsaliency, jprog, jpixel, jsrnet) = (
    importlib.import_module(f"elvis_tpu.{m}")
    for m in ("degrade.adaptive", "scoring.complexity", "scoring.fusion",
              "scoring.saliency", "restore.progressive", "metrics.pixel", "models.srnet"))
(tadaptive, tcomplexity, tfusion, tsaliency, tprog, tpixel, tsrnet) = (
    importlib.import_module(f"elvis_tpu_torch.{m}")
    for m in ("degrade.adaptive", "scoring.complexity", "scoring.fusion",
              "scoring.saliency", "restore.progressive", "metrics.pixel", "models.srnet"))
from elvis_tpu_torch.models.io import params_from_flax  # noqa: E402

B = 8
PSNR_TOL_DB = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _narrow_net(rng, feats=16, convs=2):
    """A random-weight SRNetCompact on both sides from one numpy tree; the
    weights are scaled so the residual is a few grey levels, as a trained
    net's is."""
    jm = jsrnet.SRNetCompact(features=feats, num_convs=convs)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 8, 8, 3)))

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) == 4 else 1
        return (0.5 * rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map(leaf, shapes)
    params["params"]["tail"] = jax.tree_util.tree_map(lambda a: 0.05 * a,
                                                      params["params"]["tail"])
    tm = tsrnet.SRNetCompact(features=feats, num_convs=convs)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return (jsrnet.srnet_upsample_fn(jm, params),
            tsrnet.srnet_upsample_fn(tm.eval().requires_grad_(False)))


def _jax_slice(video, up):
    x = jnp.asarray(video)
    cx = jcomplexity.spatial_temporal_complexity(x, B)
    sal = jsaliency.motion_contrast_saliency(x)
    scores = jfusion.removability_scores(cx.SC, cx.TC, jsaliency.saliency_to_block_mask(sal, B))
    degraded, levels = jadaptive.adaptive_downsample(x, scores, B)
    restored = jprog.progressive_restore(degraded, levels, B, upsample_fn=up)
    fg = sal >= 0.5
    return {"levels": _np(levels), "degraded": _np(degraded), "restored": _np(restored),
            "psnr": _np(jpixel.masked_psnr(x, restored, fg)),
            "psnr_bg": _np(jpixel.masked_psnr(x, restored, ~fg)),
            "psnr_degraded": _np(jpixel.masked_psnr(x, degraded)),
            "ssim": _np(jpixel.masked_ssim(x, restored, fg))}


def _torch_slice(video, up):
    x = torch.from_numpy(video)
    cx = tcomplexity.spatial_temporal_complexity(x, B)
    sal = tsaliency.motion_contrast_saliency(x)
    scores = tfusion.removability_scores(cx.SC, cx.TC, tsaliency.saliency_to_block_mask(sal, B))
    degraded, levels = tadaptive.adaptive_downsample(x, scores, B)
    restored = tprog.progressive_restore(degraded, levels, B, upsample_fn=up)
    fg = sal >= 0.5
    return {"levels": _np(levels), "degraded": _np(degraded), "restored": _np(restored),
            "psnr": _np(tpixel.masked_psnr(x, restored, fg)),
            "psnr_bg": _np(tpixel.masked_psnr(x, restored, ~fg)),
            "psnr_degraded": _np(tpixel.masked_psnr(x, degraded)),
            "ssim": _np(tpixel.masked_ssim(x, restored, fg))}


def test_slice_neural_psnr_matches_jax(rng, tiny_video):
    jup, tup = _narrow_net(rng)
    j, t = _jax_slice(tiny_video, jup), _torch_slice(tiny_video, tup)
    np.testing.assert_array_equal(t["levels"], j["levels"])
    assert j["levels"].max() >= 2  # the loop runs at least two SR stages
    assert t["restored"].dtype == np.uint8 and t["restored"].shape == tiny_video.shape
    for key in ("psnr", "psnr_bg", "psnr_degraded"):
        np.testing.assert_allclose(t[key], j[key], atol=PSNR_TOL_DB, err_msg=key)
    np.testing.assert_allclose(t["ssim"], j["ssim"], atol=1e-4)
    # the net changed the result: not the progressive-Lanczos output
    lanczos = _np(tprog.progressive_restore(torch.from_numpy(t["degraded"]),
                                            torch.from_numpy(t["levels"]), B))
    assert np.abs(lanczos.astype(int) - t["restored"].astype(int)).max() > 0


def _codec_slice(video, up, side, tmp_path):
    """score -> adaptive_downsample -> encode at a target -> decode ->
    sidecar out and in -> progressive_restore with the maps read back ->
    masked PSNR, in one package (``side``: "jax" or "torch")."""
    target, fps, gop = 150_000, 30.0, 3
    if side == "jax":
        from elvis_tpu.codec import dispatch, sidecar
        x = jnp.asarray(video)
        cx = jcomplexity.spatial_temporal_complexity(x, B)
        sal = jsaliency.motion_contrast_saliency(x)
        scores = jfusion.removability_scores(cx.SC, cx.TC,
                                             jsaliency.saliency_to_block_mask(sal, B))
        degraded, levels = jadaptive.adaptive_downsample(x, scores, B)
        codec = dispatch.make_pipeline_codec("nvc", str(tmp_path), 64, 48)
        stream = codec.encode(_np(degraded), target_bitrate=target, framerate=fps, gop=gop)
        decoded = jnp.asarray(codec.decode(stream))
        as_maps, prog, pixel = (lambda m: jnp.asarray(m.astype(np.int32))), jprog, jpixel
    else:
        from elvis_tpu_torch.codec import dispatch, sidecar
        x = torch.from_numpy(video)
        cx = tcomplexity.spatial_temporal_complexity(x, B)
        sal = tsaliency.motion_contrast_saliency(x)
        scores = tfusion.removability_scores(cx.SC, cx.TC,
                                             tsaliency.saliency_to_block_mask(sal, B))
        degraded, levels = tadaptive.adaptive_downsample(x, scores, B)
        codec = dispatch.make_pipeline_codec("nvc", str(tmp_path), 64, 48, device="cpu")
        stream = codec.encode(degraded, target_bitrate=target, framerate=fps, gop=gop)
        decoded = codec.decode(stream)
        as_maps, prog, pixel = (lambda m: torch.from_numpy(m.astype(np.int32))), tprog, tpixel
    path = str(tmp_path / f"{side}_maps.npz")
    size = sidecar.save_strength_maps_npz(_np(levels), path)
    maps = sidecar.load_strength_maps_npz(path)
    restored = prog.progressive_restore(decoded, as_maps(maps), B, upsample_fn=up)
    return {"levels": _np(levels), "maps": maps, "stream": stream, "sidecar_size": size,
            "sidecar_blob": sidecar.encode_strength_maps(_np(levels)),
            "decoded": _np(decoded), "restored": _np(restored),
            "psnr_decoded": _np(pixel.masked_psnr(x, decoded)),
            "psnr": _np(pixel.masked_psnr(x, restored))}


def test_slice_through_the_codec_matches_jax(rng, tiny_video, tmp_path):
    """Tolerances: restored PSNR within 0.05 dB per frame (the decoders
    differ by 1 LSB on single pixels and the bf16 net on single roundings),
    stream length within 2%, sidecar bytes equal."""
    jup, tup = _narrow_net(rng)
    j = _codec_slice(tiny_video, jup, "jax", tmp_path)
    t = _codec_slice(tiny_video, tup, "torch", tmp_path)
    np.testing.assert_array_equal(t["levels"], j["levels"])
    np.testing.assert_array_equal(t["maps"], t["levels"])  # the sidecar brought them back
    assert t["sidecar_size"] == j["sidecar_size"] and t["sidecar_blob"] == j["sidecar_blob"]
    assert abs(len(t["stream"]) - len(j["stream"])) <= 0.02 * len(j["stream"])
    from elvis_tpu_torch.codec.nvc.codec import NvcCodec
    assert NvcCodec("cpu").probe(t["stream"]).base_qp != 32  # the rate model moved the QP
    assert t["restored"].dtype == np.uint8 and t["restored"].shape == tiny_video.shape
    np.testing.assert_allclose(t["psnr_decoded"], j["psnr_decoded"], atol=0.05)
    np.testing.assert_allclose(t["psnr"], j["psnr"], atol=0.05)
    assert t["psnr"].mean() > 25.0
    print(f"stream {len(t['stream'])} and {len(j['stream'])} bytes; restored PSNR "
          f"{t['psnr'].mean():.4f} and {j['psnr'].mean():.4f} dB")


@pytest.mark.parametrize("name", ["progressive_lanczos", "no_checkpoints"])
def test_classical_backends_match(rng, tiny_video, name):
    scores = rng.random((5, 6, 8)).astype(np.float32)
    deg, lv = tadaptive.adaptive_downsample(torch.from_numpy(tiny_video),
                                            torch.from_numpy(scores), B)
    if name == "no_checkpoints":  # the neural slot degrades to Lanczos
        tfn, tprov = tresolve("realesrgan", TConfig(auto_load_checkpoints=False), device="cpu")
        jfn, jprov = jresolve("realesrgan", JConfig(auto_load_checkpoints=False))
    else:
        tfn, tprov = tresolve(name, TConfig(), device="cpu")
        jfn, jprov = jresolve(name, JConfig())
    assert tprov == jprov
    got = _np(tfn(deg, lv, B))
    want = _np(jfn(jnp.asarray(_np(deg)), jnp.asarray(_np(lv)), B))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_realesrgan_resolves_to_committed_student(rng):
    """The default slot loads srnet_student (256 ch x 6 convs) from the
    port's committed weights and restores like the JAX tier on a small
    crop (bf16 on both sides: 1 LSB per pixel, PSNR within 0.01 dB)."""
    tfn, tprov = tresolve("realesrgan", TConfig(), device="cpu")
    jfn, jprov = jresolve("realesrgan", JConfig())
    assert tprov.startswith("progressive_neural[srnet_student:")
    assert tprov.endswith("srnet_student.npz]")
    assert jprov.startswith("progressive_neural[srnet_student:")
    frames = (rng.random((1, 16, 16, 3)) * 255).astype(np.uint8)
    lv = np.full((1, 2, 2), 1, np.int32)
    deg = _np(tadaptive.adaptive_downsample(torch.from_numpy(frames),
                                            torch.from_numpy(lv / 3.0 + 1e-3), B)[0])
    got = _np(tfn(torch.from_numpy(deg), torch.from_numpy(lv), B))
    want = _np(jfn(jnp.asarray(deg), jnp.asarray(lv), B))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_allclose(
        _np(tpixel.masked_psnr(torch.from_numpy(frames), torch.from_numpy(got))),
        _np(jpixel.masked_psnr(jnp.asarray(frames), jnp.asarray(want))), atol=PSNR_TOL_DB)


def test_staged_and_per_stage_upsamplers(rng, tiny_video):
    """StagedUpsampler and a per-stage list route like the JAX loop: a
    prefix on every stage but the last, the final one last."""
    scores = rng.random((5, 6, 8)).astype(np.float32)
    scores[:, 0, 0] = 1.0  # max level 3: three stages
    deg, lv = tadaptive.adaptive_downsample(torch.from_numpy(tiny_video),
                                            torch.from_numpy(scores), B)
    jdeg, jlv = jnp.asarray(_np(deg)), jnp.asarray(_np(lv))

    def t_bright(f):
        return tprog.lanczos_upsample_2x(f) + 3.0

    def j_bright(f):
        return jprog.lanczos_upsample_2x(f) + 3.0

    for t_up, j_up in (
        (tprog.StagedUpsampler(tprog.lanczos_upsample_2x, t_bright),
         jprog.StagedUpsampler(jprog.lanczos_upsample_2x, j_bright)),
        ([t_bright, tprog.lanczos_upsample_2x, t_bright],
         [j_bright, jprog.lanczos_upsample_2x, j_bright]),
    ):
        got = _np(tprog.progressive_restore(deg, lv, B, upsample_fn=t_up))
        want = _np(jprog.progressive_restore(jdeg, jlv, B, upsample_fn=j_up))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="one upsample_fn per stage"):
        tprog.progressive_restore(deg, lv, B, upsample_fn=[t_bright])


def test_registry():
    assert "progressive_lanczos" in available_restorers("downsample")
    assert get_restorer("downsample", "progressive_lanczos") is tprog._progressive_lanczos
    with pytest.raises(KeyError):
        get_restorer("downsample", "nope")


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tresolve("realesrgan", TConfig())
