"""Port parity: ``elvis_tpu_torch.train.evaluate`` (the held-out SR and
deblur evaluators) against ``elvis_tpu.train.evaluate``.

The JAX package draws its procedural clips, scores and codec noise from
``PRNGKey(9999/9998/7/3)``, the port from torch generators seeded with the
same numbers (an intended divergence): the parity runs hand the port JAX's
clips, scores and codec-noise draws, at 2 frames of 64 px, with a small
SRNetCompact (16 x 2) and DeblurUNet (16 features, 2 levels) in float32 at
JAX's parameters (random tails). Tolerances: every PSNR within 0.01 dB,
every SSIM within 1e-4 (the values as both packages round them, to 3 and
4 decimals).
The photo clips are equal to JAX's (the same PIL and photographs).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu_torch.models.io import params_from_flax

FRAMES, SIZE, B = 2, 64, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _with_random_tail(params, seed):
    params = jax.tree.map(np.asarray, params)
    tail = params["params"]["tail"]
    tail["kernel"] = (0.02 * np.random.default_rng(seed).standard_normal(tail["kernel"].shape)
                      ).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's clips, scores and codec-noise draws, as its evaluators take them."""
    from elvis_tpu.train.evaluate import holdout_clips

    clips = holdout_clips(FRAMES, SIZE)
    scores = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (FRAMES, SIZE // B,
                                                                   SIZE // B)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    qp = np.asarray(jax.random.uniform(k1, (FRAMES, 1, 1, 1, 1, 1), minval=16.0,
                                       maxval=38.0)).reshape(FRAMES)
    apply = np.asarray(jax.random.bernoulli(k2, 0.7, (FRAMES, 1, 1, 1))).reshape(FRAMES)
    return clips, scores, (qp, apply)


def _close(got, want):
    assert set(got) == set(want)
    for fam in want:
        for k, v in want[fam].items():
            tol = 1e-2 if "psnr" in k else 1e-4
            assert abs(got[fam][k] - v) <= tol, (fam, k, got[fam][k], v)


def test_sr_holdout_eval_equals_jax_on_its_clips_and_scores(jax_draws):
    from elvis_tpu.models import SRNetCompact as JCompact
    from elvis_tpu.train.evaluate import sr_holdout_eval as jeval
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.train.evaluate import sr_holdout_eval

    clips, scores, draws = jax_draws
    assert set(clips) == {"photo", "leaves", "legacy"}
    jm = JCompact(features=16, num_convs=2, dtype=jnp.float32)
    params = _with_random_tail(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), 1)
    want = jeval(lambda f: jm.apply(params, f), frames=FRAMES, size=SIZE)
    tm = SRNetCompact(16, 2, dtype=torch.float32)
    tm.load_state_dict(params_from_flax(params))
    got = sr_holdout_eval(srnet_upsample_fn(tm), frames=FRAMES, size=SIZE, device="cpu",
                          clips=clips, scores=torch.from_numpy(scores),
                          codec_draws=tuple(torch.from_numpy(x) for x in draws))
    assert list(got) == list(want) == ["photo", "photo_codec", "leaves", "leaves_codec",
                                       "legacy", "legacy_codec"]
    _close(got, want)
    assert any(abs(r["dpsnr"]) > 0.01 for r in want.values())  # the net is not Lanczos


def test_deblur_holdout_eval_equals_jax_on_its_clips_and_scores(jax_draws):
    from elvis_tpu.models import DeblurUNet as JDeblur
    from elvis_tpu.train.evaluate import deblur_holdout_eval as jeval
    from elvis_tpu_torch.models import DeblurUNet
    from elvis_tpu_torch.train.evaluate import deblur_holdout_eval

    clips, scores, _ = jax_draws
    jm = JDeblur(features=16, levels=2, dtype=jnp.float32, max_strength=10.0)
    params = _with_random_tail(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                       jnp.zeros((1, 4, 4), jnp.int32), B), 2)
    want = jeval(lambda f, lv, b: jm.apply(params, f, lv, b), frames=FRAMES, size=SIZE)
    tm = DeblurUNet(features=16, levels=2, dtype=torch.float32, max_strength=10.0)
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = deblur_holdout_eval(lambda f, lv, b: tm(f, lv, b), frames=FRAMES, size=SIZE,
                                  device="cpu", clips=clips, scores=torch.from_numpy(scores))
    _close(got, want)


def test_photo_clips_equal_jax_and_drop_out_without_pil(monkeypatch):
    """The photo families are JAX's own (PIL here); without PIL the photo
    drops out where JAX's ``photo_image`` returns None, the procedural
    families stay, and ``photo_clips_multi`` raises naming PIL."""
    import builtins

    from elvis_tpu.train import evaluate as jev
    from elvis_tpu_torch.train import evaluate as tev

    np.testing.assert_array_equal(tev._photo_clip(FRAMES, SIZE), jev._photo_clip(FRAMES, SIZE))
    for a, b in zip(tev.photo_clips_multi(2, 48, 4), jev.photo_clips_multi(2, 48, 4)):
        np.testing.assert_array_equal(a, b)
    clips = tev.holdout_clips(FRAMES, SIZE, device="cpu")
    assert list(clips) == ["photo", "leaves", "legacy"]
    assert all(c.shape == (FRAMES, SIZE, SIZE, 3) and c.dtype == np.float32
               for c in clips.values())

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name.startswith("PIL"):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert tev.photo_image() is None and jev.photo_image() is None
    assert list(tev.holdout_clips(FRAMES, SIZE, device="cpu")) == ["leaves", "legacy"]
    with pytest.raises(ImportError, match="PIL"):
        tev.photo_clips_multi(2, 48, 4)


def test_photo_eval_multi_and_the_cli(tmp_path, capsys):
    """``sr_photo_eval_multi`` over the photo's crops and scales, and
    ``main`` on the port's ``.npz`` weights (an SR net and a deblur net)."""
    from elvis_tpu_torch.models import DeblurUNet, SRNetCompact
    from elvis_tpu_torch.models.io import model_meta, write_npz
    from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x
    from elvis_tpu_torch.train.evaluate import main, sr_photo_eval_multi

    res = sr_photo_eval_multi(lanczos_upsample_2x, frames=2, size=48, max_clips=3, device="cpu")
    assert res["n"] == 3 and res["dpsnr_mean"] == 0.0 and res["dssim_std"] == 0.0
    assert sr_photo_eval_multi(lanczos_upsample_2x, device="cpu", clips=[]) == {"n": 0}

    torch.manual_seed(0)
    for name, model in (("srnet_compact", SRNetCompact(8, 1)), ("deblur", DeblurUNet(8, 2))):
        write_npz(str(tmp_path / f"{name}.npz"), dict(model.named_parameters()),
                  model_meta(model))
        assert main(["--ckpt", str(tmp_path / name), "--frames", "2", "--size", "32", "--json"],
                    device="cpu") == 0
        out = json.loads(capsys.readouterr().out)
        assert list(out) == (["photo", "photo_codec", "leaves", "leaves_codec", "legacy",
                              "legacy_codec"] if name != "deblur"
                             else ["photo", "leaves", "legacy"])
        assert all(np.isfinite(v) for r in out.values() for v in r.values())
