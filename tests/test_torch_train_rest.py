"""Port parity: the diffusion, inpaint, saliency and perceptual trainers
(``elvis_tpu_torch.train.cli``) and ``DiffusionRestorer.loss`` against
``elvis_tpu``.

JAX's own loss functions and initial parameters are recorded from its
``Trainer.__init__`` while ``train_<name>(0, None)`` runs (with no steps it
never compiles its batch maker), with the nets in float32. Both packages
then take two AdamW steps from those parameters on the same numpy batches:
JAX through its recorded loss on one device, the port through its
``train_<name>`` with its batches replaced and its net built from JAX's
parameters. The tails (output convs), which both packages initialise at
zero, get the same random values first, so every layer's gradient is
nonzero from the first step. Tolerances:

  * ``DiffusionRestorer.loss`` at JAX's ``t``, ``gamma`` and noise (float32
    UNet): within 1e-6; its gradient within 1e-6 of JAX's, relative to the
    largest gradient element (with PyTorch's own CPU convolutions: oneDNN's
    float32 backward measured ~1e-3 relative off a float64 reference);
  * two steps of each trainer in float32: each step's loss within 1e-5
    relative, every parameter within 1e-5 of JAX's (they move by ~1e-3
    and more: two steps at the trainers' learning rates);
  * the batches' own parts against JAX: the inpaint trainer's seed (the
    temporal fill on the same clip and mask) with known pixels equal and
    hole pixels within 1e-3 grey level; the saliency teacher within 1e-5;
    the perceptual ends (blur, area-down / linear-up, noise, codec noise
    through ``codec_noise_at`` at JAX's QP and apply draws) within 1e-3 on
    all but a 1e-4 share of pixels (a quantizer tie).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elvis_tpu_torch.models.io import params_from_flax

FRAMES, PATCH, BATCH = 4, 32, 4
STEPS_LR = {"diffusion": 2e-4, "inpaint": 2e-4, "saliency": 1e-3, "perceptual": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _f32_jax_models(mp):
    """The JAX package's trainer nets in float32 (its PerceptualNet is
    float32 already)."""
    import functools

    from elvis_tpu import models as jmodels
    from elvis_tpu.models import diffusion as jdiff

    class F32Diffusion(jdiff.DiffusionRestorer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.unet = jdiff._CondUNet(features=self.unet.features, dtype=jnp.float32)

    mp.setattr(jmodels, "InpaintNet", functools.partial(jmodels.InpaintNet, dtype=jnp.float32))
    mp.setattr(jmodels, "SaliencyNet",
               functools.partial(jmodels.SaliencyNet, dtype=jnp.float32))
    mp.setattr(jmodels, "DiffusionRestorer", F32Diffusion)


TAILS = {"diffusion": "eps", "inpaint": "tail", "saliency": "head", "perceptual": None}


@pytest.fixture(scope="module")
def recorded():
    """{name: (JAX loss_fn, initial params with a random tail)} from JAX's
    ``train_<name>(0, None)`` at small sizes, float32 nets."""
    from elvis_tpu.train import cli as jcli
    from elvis_tpu.train import trainer as jtrainer

    mp = pytest.MonkeyPatch()
    _f32_jax_models(mp)
    seen = {}
    init = jtrainer.Trainer.__init__

    def record(self, loss_fn, params, *args, **kwargs):
        seen["last"] = (loss_fn, _np_tree(params))
        init(self, loss_fn, params, *args, **kwargs)

    mp.setattr(jtrainer.Trainer, "__init__", record)
    out = {}
    try:
        for name, kw in (("diffusion", dict(batch=BATCH, patch=PATCH, photo_fraction=0.0)),
                         ("inpaint", dict(frames=FRAMES, patch=PATCH)),
                         ("saliency", dict(frames=FRAMES, patch=PATCH)),
                         ("perceptual", dict(batch=BATCH, patch=PATCH))):
            getattr(jcli, f"train_{name}")(0, None, **kw)
            loss_fn, params = seen.pop("last")
            if TAILS[name]:
                tail = params["params"][TAILS[name]]
                rng = np.random.default_rng(len(name))
                tail["kernel"] = (0.02 * rng.standard_normal(tail["kernel"].shape)
                                  ).astype(np.float32)
            out[name] = (loss_fn, params)
    finally:
        mp.undo()
    return out


def _diffusion_draws(key, n):
    t_rng, n_rng, g_rng = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(t_rng, (n,), 1, 1000))
    gamma = np.asarray(jax.random.uniform(g_rng, (n, 1, 1, 1)))
    noise = np.asarray(jax.random.normal(n_rng, (n, PATCH, PATCH, 3)))
    return t, gamma, noise


@pytest.fixture(scope="module")
def batches():
    """Two seeded numpy batches per trainer, their derived parts made by the
    JAX package's functions, and the port's counterparts of those parts."""
    from elvis_tpu.degrade import adaptive_blur as jblur
    from elvis_tpu.restore.inpaint import restore_removal_temporal as jfill
    from elvis_tpu.scoring import motion_contrast_saliency as jsal
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal as tfill
    from elvis_tpu_torch.scoring import motion_contrast_saliency as tsal

    rng = np.random.default_rng(21)
    by = PATCH // 8
    out = {name: [] for name in TAILS}
    parts = {"seed": [], "teacher": []}
    jfill_jit = jax.jit(lambda f, m: jfill(f, m, 8))
    for step in range(2):
        clean = (rng.random((BATCH, PATCH, PATCH, 3)) * 255).astype(np.float32)
        scores = np.sqrt(rng.random((BATCH, by, by))).astype(np.float32)
        degraded, _ = jblur(jnp.asarray(clean), jnp.asarray(scores), 8, 10)
        out["diffusion"].append((clean, np.asarray(degraded),
                                 *_diffusion_draws(jax.random.PRNGKey(30 + step), BATCH)))

        pan = (rng.random((PATCH + 3 * FRAMES, PATCH + 3 * FRAMES, 3)) * 255).astype(np.float32)
        clip = np.stack([pan[t: t + PATCH, 2 * t: 2 * t + PATCH] for t in range(FRAMES)])
        mask = (rng.random((FRAMES, by, by)) < 0.25).astype(np.int8)
        holed = np.where(np.repeat(np.repeat(mask.astype(bool), 8, 1), 8, 2)[..., None], 0.0,
                         clip).astype(np.float32)
        seeded = np.asarray(jfill_jit(jnp.asarray(holed), jnp.asarray(mask)))
        parts["seed"].append((tfill(torch.from_numpy(holed), torch.from_numpy(mask), 8).numpy(),
                              seeded, mask))
        out["inpaint"].append((clip, seeded, mask))

        target = np.asarray(jsal(jnp.asarray(clip)))
        parts["teacher"].append((tsal(torch.from_numpy(clip)).numpy(), target))
        out["saliency"].append((clip, target))

        t1 = 0.05 + 0.5 * rng.random((BATCH, 1, 1, 1)).astype(np.float32)
        end = (rng.random((BATCH, PATCH, PATCH, 3)) * 255).astype(np.float32)
        out["perceptual"].append((clean, (1 - t1) * clean + t1 * end,
                                  (1 - t1 - 0.3) * clean + (t1 + 0.3) * end))
    return out, parts


def test_diffusion_loss_and_gradient_equal_jax_at_jax_draws(recorded, batches):
    from elvis_tpu.models.diffusion import DiffusionRestorer as JDiff
    from elvis_tpu.models.diffusion import _CondUNet as JUNet
    from elvis_tpu_torch.models import DiffusionRestorer

    _, params = recorded["diffusion"]
    clean, degraded, t, gamma, noise = batches[0]["diffusion"][0]
    jd = JDiff()
    jd.unet = JUNet(features=32, dtype=jnp.float32)
    key = jax.random.PRNGKey(30)
    jloss, jgrad = jax.value_and_grad(lambda p: jd.loss(p, key, jnp.asarray(clean),
                                                        jnp.asarray(degraded)))(params)
    td = DiffusionRestorer()
    td.unet.dtype = torch.float32
    p = {k: v.requires_grad_(True) for k, v in params_from_flax(params).items()}
    # oneDNN's float32 convolution backward on the CPU can be ~1e-3
    # relative off a float64 reference on this loss (measured on an x86
    # CPU); PyTorch's own kernels (and JAX's) are within 1e-8 of it
    with torch.backends.mkldnn.flags(enabled=False):
        tloss = td.loss(torch.from_numpy(clean), torch.from_numpy(degraded),
                        t=torch.from_numpy(t), gamma=torch.from_numpy(gamma),
                        noise=torch.from_numpy(noise), params=p)
        tgrad = dict(zip(p, torch.autograd.grad(tloss, list(p.values()))))
    assert abs(float(tloss) - float(jloss)) <= 1e-6, (float(tloss), float(jloss))
    want = params_from_flax(_np_tree(jgrad))
    scale = max(float(w.abs().max()) for w in want.values())
    worst = max(float((tgrad[k] - want[k]).abs().max()) for k in want)
    assert scale > 0 and worst <= 1e-6 * scale, (worst, scale)
    # drawn from a generator where not given: a finite loss, the same for
    # the same seed
    td.unet.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        a, b = (td.loss(torch.from_numpy(clean), torch.from_numpy(degraded),
                        torch.Generator().manual_seed(4)) for _ in range(2))
    assert torch.isfinite(a) and float(a) > 0 and torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        td.loss(torch.from_numpy(clean), torch.from_numpy(degraded))


def test_trainer_batch_parts_equal_jax(batches):
    """The inpaint seed, the saliency teacher and the perceptual ends, made
    by the port from the same inputs (and the codec ends at JAX's draws)."""
    from elvis_tpu.ops.filter import gaussian_blur as jgauss
    from elvis_tpu.ops.resize import resize as jresize
    from elvis_tpu.train.data import codec_noise as jcodec
    from elvis_tpu_torch.train.cli import perceptual_endpoints

    _, parts = batches
    for got, want, mask in parts["seed"]:
        hole = np.repeat(np.repeat(mask.astype(bool), 8, 1), 8, 2)
        assert np.array_equal(got[~hole], want[~hole])
        assert np.abs(got[hole] - want[hole]).max() <= 1e-3
    for got, want in parts["teacher"]:
        np.testing.assert_allclose(got, want, atol=1e-5)

    clean = (np.random.default_rng(22).random((BATCH, PATCH, PATCH, 3)) * 255).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    qp = np.asarray(jax.random.uniform(k1, (BATCH, 1, 1, 1, 1, 1), minval=16.0,
                                       maxval=38.0)).reshape(BATCH)
    apply = np.asarray(jax.random.bernoulli(k2, 0.7, (BATCH, 1, 1, 1))).reshape(BATCH)
    normal = np.asarray(jax.random.normal(key, clean.shape))
    c = jnp.asarray(clean)
    want = np.stack([
        np.asarray(jgauss(jgauss(c, 5, 2.0), 5, 2.0)),
        np.asarray(jresize(jresize(c, (PATCH // 4, PATCH // 4), method="area"),
                           (PATCH, PATCH), method="linear")),
        np.clip(clean + 40.0 * normal, 0, 255),
        np.asarray(jcodec(key, c)),
    ])
    got = perceptual_endpoints(torch.from_numpy(clean), torch.from_numpy(normal),
                               torch.from_numpy(qp), torch.from_numpy(apply)).numpy()
    assert got.shape == want.shape == (4, BATCH, PATCH, PATCH, 3)
    far = np.abs(got - want) > 1e-3
    assert far[:3].mean() == 0 and far[3].mean() <= 1e-4, [f.mean() for f in far]


def _port_net(name, params):
    """The port's trainer net for ``name`` in float32 at JAX's parameters."""
    from elvis_tpu_torch.metrics.perceptual import PerceptualNet
    from elvis_tpu_torch.models import DiffusionRestorer, InpaintNet, SaliencyNet

    state = params_from_flax(params)
    if name == "diffusion":
        net = DiffusionRestorer()
        net.unet.dtype = torch.float32
        net.unet.load_state_dict(state)
        return net
    net = {"inpaint": lambda: InpaintNet(dtype=torch.float32),
           "saliency": lambda: SaliencyNet(dtype=torch.float32),
           "perceptual": PerceptualNet}[name]()
    net.load_state_dict(state)
    return net


@pytest.mark.parametrize("name", ["diffusion", "inpaint", "saliency", "perceptual"])
def test_two_steps_equal_jax_from_its_initial_parameters(name, recorded, batches, monkeypatch):
    from elvis_tpu.parallel import make_mesh as jmake_mesh
    from elvis_tpu.train import Trainer as JTrainer
    from elvis_tpu_torch import models as tmodels
    from elvis_tpu_torch.metrics import perceptual as tperc
    from elvis_tpu_torch.train import cli as tcli
    from elvis_tpu_torch.train import trainer as ttrainer

    loss_fn, params = recorded[name]
    data = batches[0][name]
    lr = STEPS_LR[name]
    jt = JTrainer(loss_fn, jax.tree.map(jnp.asarray, params),
                  mesh=jmake_mesh(devices=[0]), learning_rate=lr)
    jl = [jt.step(tuple(jnp.asarray(x) for x in
                        (batch[:2] if name in ("diffusion", "saliency") else batch)),
                  jax.random.PRNGKey(30 + i))
          for i, batch in enumerate(data)]

    net = _port_net(name, params)
    owner = tperc if name == "perceptual" else tmodels
    cls = {"diffusion": "DiffusionRestorer", "inpaint": "InpaintNet", "saliency": "SaliencyNet",
           "perceptual": "PerceptualNet"}[name]
    monkeypatch.setattr(owner, cls, lambda *a, **k: net)
    it = iter(data)
    step = ttrainer.Trainer.step
    monkeypatch.setattr(ttrainer.Trainer, "step", lambda self, batch: step(
        self, tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in next(it))))
    kw = {"diffusion": dict(batch=BATCH, patch=PATCH), "perceptual": dict(batch=BATCH,
                                                                          patch=PATCH)}.get(
        name, dict(frames=FRAMES, patch=PATCH))
    with torch.backends.mkldnn.flags(enabled=False):  # see the loss test
        tt = getattr(tcli, f"train_{name}")(2, None, lr=lr, photo_fraction=0.0, device="cpu",
                                            log_every=100, **kw)
    np.testing.assert_allclose(tt.losses, jl, rtol=1e-5)
    want = params_from_flax(_np_tree(jt.state.params))
    got = tt.params()
    start = params_from_flax(params)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    worst = max(float((want[k] - got[k]).abs().max()) for k in want)
    assert moved > lr and worst <= 1e-5, (moved, worst)


@pytest.mark.parametrize("name", ["diffusion", "inpaint", "saliency", "perceptual"])
def test_checkpoint_loads_through_its_loader(name, tmp_path):
    """Each trainer's ``<ckpt_dir>/<name>.npz`` (at its default nets, from
    the batch maker's own draws: finite losses) rebuilds the trained net
    through its loader, whose forward equals the trained module's."""
    from elvis_tpu_torch.metrics.perceptual import load_perceptual
    from elvis_tpu_torch.models import DiffusionRestorer
    from elvis_tpu_torch.models.io import load_diffusion, load_inpaint, load_saliency
    from elvis_tpu_torch.train import cli

    kw = dict(batch=2, patch=PATCH) if name in ("diffusion", "perceptual") else dict(
        frames=FRAMES, patch=PATCH)
    tr = getattr(cli, f"train_{name}")(2, str(tmp_path), photo_fraction=0.0, device="cpu",
                                       log_every=100, **kw)
    assert len(tr.losses) == 2 and all(np.isfinite(tr.losses))
    path = str(tmp_path / f"{name}.npz")
    rng = np.random.default_rng(23)
    x = torch.from_numpy((rng.random((FRAMES, PATCH, PATCH, 3)) * 255).astype(np.float32))
    with torch.no_grad():
        if name == "diffusion":
            trained = DiffusionRestorer()
            trained.unet.load_state_dict(tr.params())
            assert torch.equal(load_diffusion(path, device="cpu").sample(x, steps=2),
                               trained.sample(x, steps=2))
        elif name == "inpaint":
            mask = torch.from_numpy((rng.random((FRAMES, 4, 4)) < 0.25).astype(np.int8))
            assert torch.equal(load_inpaint(path, device="cpu")(x, mask, 8), tr.model(x, mask, 8))
        elif name == "saliency":
            assert torch.equal(load_saliency(path, device="cpu")(x), tr.model(x))
        else:
            got, want = load_perceptual(path, device="cpu")(x), tr.model(x)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cli_runs_every_trainer_and_passes_the_photo_fraction(monkeypatch):
    """``main`` takes the four trainers with the flags each one takes."""
    import inspect

    from elvis_tpu_torch.train import cli

    seen = {}
    for name in ("diffusion", "inpaint", "perceptual", "saliency"):
        real = cli._TRAINERS[name]

        def fake(steps, ckpt_dir, _real=real, _name=name, **kw):
            assert set(kw) <= set(inspect.signature(_real).parameters)
            seen[_name] = kw

        fake.__signature__ = inspect.signature(real)
        monkeypatch.setitem(cli._TRAINERS, name, fake)
        assert cli.main([name, "--steps", "1", "--val-every", "3", "--photo-fraction", "0"],
                        device="cpu") == 0
    assert seen["diffusion"] == dict(lr=2e-4, val_every=3, photo_fraction=0.0, device="cpu")
    for name in ("inpaint", "perceptual", "saliency"):
        assert seen[name] == dict(lr=2e-4, photo_fraction=0.0, device="cpu")
    assert json.dumps(sorted(cli._TRAINERS)) == json.dumps(
        sorted(__import__("elvis_tpu.train.cli", fromlist=["_TRAINERS"])._TRAINERS))
