"""Port parity: ``elvis_tpu_torch.train`` (the sharded trainer with AdamW,
the training data, the SR and deblur trainers, the CLI) against
``elvis_tpu.train``.

The trainers start from the JAX package's initial parameters (through
``models.io.params_from_flax``) and take JAX's own batches, so the same
updates must come out. Tolerances, stated per test:

  * the schedule and AdamW's arithmetic equal optax's to float32 rounding
    (2e-6 relative: the cosine and the bias corrections may land an ulp
    apart);
  * ``_train_sr`` over four steps (the first at learning rate 0) in float32:
    every parameter within 1e-6 of JAX's (they move by ~7e-4), each step's
    loss within 1e-5 relative; in bf16 (the nets' trunk dtype, where the two
    packages' convolutions round differently) the losses within 1e-4
    relative;
  * the deblur loss over three steps on a data 2 x tensor 2 mesh in both
    packages (a random tail, so no gradient starts at ~0): float32 within
    1e-5 (parameters move by ~3e-3);
  * bf16 (``_hold_bf16``): per parameter, the mean distance to JAX's at
    most 15% of the mean distance moved, at most 5% of the elements
    further apart than a quarter of the summed learning rate;
  * DP, and DP x TP, against the unsharded step in the port: 1e-6;
  * the training data: ``codec_noise`` at JAX's own QP draws equal on all
    but a 1e-4 share of pixels (a quantizer tie the two ``exp2`` round
    apart); the procedural sources, whose draws come from a torch generator
    (an intended divergence), on shape, range and statistics: the mean,
    standard deviation and high-frequency energy over 4 seeds each within
    the larger of 3 standard errors of JAX's own spread over its 4 seeds
    and 6% of JAX's value; the photo pool equal to JAX's (PIL here).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elvis_tpu_torch.models.io import params_from_flax
from elvis_tpu_torch.parallel import mesh as tmesh
from elvis_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def logical(monkeypatch):
    monkeypatch.setattr(tmesh, "devices", lambda device_type="cuda": [CPU] * 4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_schedule_equals_optax_and_starts_at_zero():
    from elvis_tpu_torch.train.trainer import warmup_cosine_decay_schedule

    for steps in (3, 4, 57, 1000):
        warm = min(100, steps // 10 + 1)
        ours = warmup_cosine_decay_schedule(0.0, 2e-4, warm, steps)
        ref = optax.warmup_cosine_decay_schedule(0.0, 2e-4, warmup_steps=warm, decay_steps=steps)
        got = np.asarray([ours(c) for c in range(steps + 3)], np.float32)
        want = np.asarray([float(ref(jnp.asarray(c, jnp.int32))) for c in range(steps + 3)],
                          np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)
        assert got[0] == 0.0


@pytest.mark.parametrize("lr", [3e-3, "schedule"])
def test_adamw_equals_optax(lr):
    from elvis_tpu_torch.train.trainer import adamw, warmup_cosine_decay_schedule

    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3, 3, 3), "b": (4,), "c": (2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    if lr == "schedule":
        ours_lr = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
        ref_lr = optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup_steps=2, decay_steps=6)
    else:
        ours_lr = ref_lr = lr
    ref = optax.adamw(ref_lr, weight_decay=1e-4)
    ref_state = ref.init(params)
    ours = adamw(ours_lr, weight_decay=1e-4)
    tp = {k: [torch.from_numpy(v.copy())] for k, v in params.items()}
    state = ours.init(tp)
    jp = dict(params)
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * 10.0 ** -step).astype(np.float32)
                 for k, s in shapes.items()}
        upd, ref_state = ref.update(grads, ref_state, jp)
        jp = optax.apply_updates(jp, upd)
        tp, state = ours.update({k: [torch.from_numpy(g)] for k, g in grads.items()}, state, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k][0].numpy(), np.asarray(jp[k]), rtol=2e-6,
                                       atol=1e-7)
    assert state.count == 5


@pytest.fixture
def jax_batches(monkeypatch):
    """The batches JAX's trainer steps on, recorded in order."""
    from elvis_tpu.train import trainer as jtrainer

    seen = []
    step = jtrainer.Trainer.step

    def recording(self, batch, rng):
        seen.append([np.asarray(x) for x in batch])
        return step(self, batch, rng)

    monkeypatch.setattr(jtrainer.Trainer, "step", recording)
    return seen


def _replay(monkeypatch, batches):
    """The port's trainer steps on ``batches`` in order instead of its own."""
    from elvis_tpu_torch.train import trainer as ttrainer

    it = iter(batches)
    step = ttrainer.Trainer.step
    monkeypatch.setattr(ttrainer.Trainer, "step",
                        lambda self, batch: step(self, tuple(torch.from_numpy(x.copy())
                                                             for x in next(it))))


def _hold_bf16(want, got, start, lr_sum):
    """bf16 trunks round differently in the two packages, and Adam turns a
    small gradient's rounding into up to a whole step: per parameter, the
    mean distance to JAX's at most 15% of the mean distance moved, and at
    most 5% of the elements further apart than a quarter of the summed
    learning rate."""
    for k in want:
        d, m = (want[k] - got[k]).abs(), (want[k] - start[k]).abs()
        assert float(d.mean()) <= 0.15 * float(m.mean()), (k, float(d.mean()), float(m.mean()))
        assert float((d > 0.25 * lr_sum).float().mean()) <= 0.05, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_sr_steps_equal_jax(dtype, jax_batches, monkeypatch):
    """Four steps of ``_train_sr`` (SRNetCompact 16 x 2, batch 4, patch 32,
    lr 1e-3: schedule 0, 1e-3, 7.5e-4, 2.5e-4) from JAX's initial
    parameters on JAX's batches. JAX trains on its data 4 x tensor 2 CPU
    mesh, the port on one device."""
    from elvis_tpu.models import SRNetCompact as JCompact
    from elvis_tpu.train import cli as jcli
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.train import cli as tcli

    jmodel = JCompact(features=16, num_convs=2, dtype=getattr(jnp, dtype))
    init = _np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    jt = jcli._train_sr(jmodel, "t", 4, None, 1e-3, 4, 32, 100, 8)
    model = SRNetCompact(16, 2, dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_flax(init))
    _replay(monkeypatch, jax_batches)
    tt = tcli._train_sr(model, "t", 4, None, 1e-3, 4, 32, 100, 8, device="cpu")
    want = params_from_flax(_np_tree(jt.state.params))
    got = tt.params()
    start = params_from_flax(init)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    worst = max(float((want[k] - got[k]).abs().max()) for k in want)
    assert moved > 5e-4  # the steps really moved every layer
    if dtype == "float32":
        assert worst <= 1e-6, (worst, moved)
    else:
        _hold_bf16(want, got, start, lr_sum=2e-3)
    # the trained parameters are in the module too
    assert all(torch.equal(p, got[n]) for n, p in model.named_parameters())
    # steps 0 and 1 run at the initial parameters (the first learning rate
    # is 0): their losses are JAX's loss of the initial net on those batches
    from elvis_tpu.restore.progressive import progressive_restore as jrestore

    assert len(tt.losses) == len(tt.step_ms) == 4
    for step in (0, 1):
        clean, degraded, levels = jax_batches[step]
        jloss = float(jnp.mean((jrestore(jnp.asarray(degraded), jnp.asarray(levels), 8,
                                         upsample_fn=lambda f: jmodel.apply(init, f),
                                         max_level=3) - clean) ** 2) / 255.0**2)
        assert tt.losses[step] == pytest.approx(jloss, rel=1e-5 if dtype == "float32" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deblur_loss_steps_on_dp_tp_equal_jax(dtype, logical):
    """Three AdamW steps (constant lr 1e-3) of DeblurUNet (16 features, 2
    levels) through the deblur loss, on a data 2 x tensor 2 mesh in both
    packages, from JAX's initial parameters on the same batches."""
    from elvis_tpu.degrade import adaptive_blur as jblur
    from elvis_tpu.models import DeblurUNet as JDeblur
    from elvis_tpu.parallel import make_mesh as jmake_mesh
    from elvis_tpu.train import Trainer as JTrainer
    from elvis_tpu_torch.models import DeblurUNet
    from elvis_tpu_torch.train import Trainer
    from elvis_tpu_torch.train.cli import deblur_loss

    b = 8
    jmodel = JDeblur(features=16, levels=2, dtype=getattr(jnp, dtype), max_strength=10.0)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        clean = (rng.random((4, 32, 32, 3)) * 255).astype(np.float32)
        scores = rng.random((4, 4, 4)).astype(np.float32)
        degraded, levels = jblur(jnp.asarray(clean), jnp.asarray(scores), b, 10)
        batches.append((clean, np.asarray(degraded), np.asarray(levels)))
    init = _np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                jnp.zeros((1, 4, 4), jnp.int32), b))
    # a trained-like tail: with the zero tail the body's first gradients are
    # ~0 and Adam's normalisation turns their rounding into whole steps
    tail = init["params"]["tail"]
    tail["kernel"] = (0.05 * rng.standard_normal(tail["kernel"].shape)).astype(np.float32)

    def jloss(p, data, rng_):
        clean, degraded, levels = data
        return jnp.mean((jmodel.apply(p, degraded, levels, b) - clean) ** 2) / 255.0**2

    # (JAX's step donates its parameter buffers: hand it a copy)
    jt = JTrainer(jloss, jax.tree.map(jnp.asarray, init), mesh=jmake_mesh((("data", 2), ("tensor", 2)),
                                               devices=[0, 1, 2, 3]), learning_rate=1e-3)
    model = DeblurUNet(features=16, levels=2, dtype=getattr(torch, dtype), max_strength=10.0)
    model.load_state_dict(params_from_flax(init))
    tt = Trainer(deblur_loss(model, b), model,
                 mesh=make_mesh((("data", 2), ("tensor", 2)), device_type="cpu"),
                 learning_rate=1e-3, device="cpu")
    for batch in batches:
        jl = jt.step(batch, jax.random.PRNGKey(0))
        tl = float(tt.step(tuple(torch.from_numpy(x.copy()) for x in batch)))
        assert tl == pytest.approx(jl, rel=1e-5 if dtype == "float32" else 1e-3)
    want = params_from_flax(_np_tree(jt.state.params))
    got = tt.params()
    start = params_from_flax(init)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    worst = max(float((want[k] - got[k]).abs().max()) for k in want)
    assert moved > 2e-3
    if dtype == "float32":
        assert worst <= 1e-5, (worst, moved)
    else:
        _hold_bf16(want, got, start, lr_sum=3e-3)
    # output channels divisible by the tensor axis: two shards, on the tensor devices
    assert len(tt.state.params["enc0a.weight"]) == 2 and len(tt.state.params["tail.weight"]) == 1
    assert len(tt.state.opt_state.mu["enc0a.weight"]) == 2


@pytest.mark.parametrize("axes", [(("data", 2),), (("data", 4),), (("data", 2), ("tensor", 2))])
def test_sharded_steps_equal_the_unsharded_step(axes, logical):
    """The same three steps (float32 SRNetCompact through the SR loss) on
    one device and on a logical DP or DP x TP mesh: equal parameters."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train import Trainer

    torch.manual_seed(0)
    base = SRNetCompact(8, 1, dtype=torch.float32)
    with torch.no_grad():
        base.tail.weight.normal_(0, 0.05)  # let every layer's gradient through
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        clean = torch.from_numpy((rng.random((4, 32, 32, 3)) * 255).astype(np.float32))
        degraded, levels = adaptive_downsample(
            clean, torch.from_numpy(rng.random((4, 4, 4)).astype(np.float32)), 8)
        batches.append((clean, degraded, levels))

    def run(mesh):
        model = SRNetCompact(8, 1, dtype=torch.float32)
        model.load_state_dict(base.state_dict())

        def loss_fn(p, data):
            up = lambda f: torch.func.functional_call(model, p, (f,))  # noqa: E731
            out = progressive_restore(data[1], data[2], 8, upsample_fn=up, max_level=3)
            return torch.mean((out - data[0]) ** 2) / 255.0**2

        tr = Trainer(loss_fn, model, mesh=mesh, learning_rate=1e-3, device="cpu")
        losses = [float(tr.step(batch)) for batch in batches]
        return tr, losses

    one, one_losses = run(make_mesh(devices=[0], device_type="cpu"))
    size = int(np.prod([n for _, n in axes]))
    many, many_losses = run(make_mesh(axes, devices=list(range(size)), device_type="cpu"))
    np.testing.assert_allclose(many_losses, one_losses, rtol=1e-6)
    a, b = one.params(), many.params()
    assert max(float((a[k] - b[k]).abs().max()) for k in a) <= 1e-6
    sharded = "tensor" in dict(axes)
    assert (len(many.state.params["head.weight"]) == 2) == sharded
    assert len(many.state.params["tail.weight"]) == 1  # 3 output channels: replicated
    with pytest.raises(ValueError, match="not divisible"):
        many.step(tuple(x[:3] for x in batches[0]))


def test_fresh_sr_nets_start_at_lanczos_in_both_packages():
    """The zero tail: an untrained net's 2x output is the clamped Lanczos-4
    upsample, from JAX's init and from the CLI's torch init alike."""
    from elvis_tpu.models import SRNetCompact as JCompact
    from elvis_tpu.restore.progressive import lanczos_upsample_2x as jlanczos
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x
    from elvis_tpu_torch.train.cli import _zero_tail

    x = (np.random.default_rng(7).random((2, 12, 16, 3)) * 255).astype(np.float32)
    jm = JCompact(features=16, num_convs=2)
    jout = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x)))
    np.testing.assert_array_equal(jout, np.clip(np.asarray(jlanczos(jnp.asarray(x))), 0, 255))
    torch.manual_seed(3)
    fresh = _zero_tail(SRNetCompact(16, 2))
    with torch.no_grad():
        tout = fresh(torch.from_numpy(x))
    want = torch.clamp(lanczos_upsample_2x(torch.from_numpy(x)), 0, 255)
    assert torch.equal(tout, want)


def test_checkpoint_round_trip_and_the_student_loads_as_its_tier(tmp_path):
    """``Trainer.save`` writes the port's weights format: ``load_srnet`` /
    ``load_deblur`` rebuild the trained nets, ``Trainer.load`` restores the
    parameters, and a trained student loads through ``resolve_sr_backend``
    with ``srnet_params_path`` under its tier's name, its outputs the
    trained module's."""
    from elvis_tpu_torch.models.io import load_deblur, load_srnet
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train.cli import main, train_srnet_student

    tr = train_srnet_student(3, str(tmp_path), batch=2, patch=32, features=8, num_convs=1,
                             photo_fraction=0.0, device="cpu", log_every=100)
    path = tmp_path / "srnet_student.npz"
    meta = json.loads((tmp_path / "srnet_student.meta.json").read_text())
    assert meta["features"] == 8 and meta["num_convs"] == 1
    assert meta["teachers"] == ["srnet_compact", "srnet", "srnet_large"]
    loaded = load_srnet(str(path), device="cpu")
    for name, p in tr.params().items():
        assert torch.equal(dict(loaded.named_parameters())[name], p), name
    fn, prov = resolve_sr_backend("srnet_student",
                                  ElvisConfig(srnet_params_path=str(path)), device="cpu")
    assert prov == f"progressive_neural[srnet_student:{path}]"
    rng = np.random.default_rng(8)
    frames = torch.from_numpy((rng.random((1, 32, 32, 3)) * 255).astype(np.float32))
    levels = torch.from_numpy(rng.integers(0, 4, (1, 4, 4)).astype(np.int32))
    with torch.no_grad():
        want = progressive_restore(frames, levels, 8, upsample_fn=lambda f: tr.model(f))
    assert torch.equal(fn(frames, levels, 8), want)
    before = tr.params()
    tr.set_params({k: torch.zeros_like(v) for k, v in before.items()})
    restored = tr.load("srnet_student")
    assert all(torch.equal(restored[k], before[k]) for k in before)

    assert main(["deblur", "--steps", "2", "--ckpt-dir", str(tmp_path)], device="cpu") == 0
    deblur = load_deblur(str(tmp_path / "deblur.npz"), device="cpu")
    assert json.loads((tmp_path / "deblur.meta.json").read_text()) == {"max_strength": 10.0}
    assert deblur.max_strength == 10.0 and deblur.features == 32


def test_student_generations_and_the_4k_finisher(tmp_path):
    """Generation 2 of the student: the dihedral teachers plus generation
    1 as an extra teacher (four in the meta); the 4K finisher over the
    frozen serving tier."""
    from elvis_tpu_torch.train.cli import train_srnet_4k, train_srnet_student

    tiny = dict(batch=2, patch=32, features=8, num_convs=1, photo_fraction=0.0, device="cpu",
                log_every=100)
    train_srnet_student(1, str(tmp_path), distill_weight=0.0, **tiny)
    assert json.loads((tmp_path / "srnet_student.meta.json").read_text())["teachers"] == []
    gen2 = tmp_path / "gen2"
    gen2.mkdir()
    train_srnet_student(1, str(gen2), teacher_dihedral=True,
                        extra_teachers=(str(tmp_path / "srnet_student"),), **tiny)
    meta2 = json.loads((gen2 / "srnet_student.meta.json").read_text())
    assert meta2["teacher_dihedral"] is True and len(meta2["teachers"]) == 4
    assert meta2["teachers"][-1].endswith("srnet_student")
    train_srnet_4k(2, str(tmp_path), **tiny)
    meta = json.loads((tmp_path / "srnet_4k.meta.json").read_text())
    assert meta == {"features": 8, "num_convs": 1, "prefix": "srnet_compact"}
    assert os.path.isfile(tmp_path / "srnet_4k.npz")


def test_cli_flags_reach_the_trainers(monkeypatch):
    """``main`` takes the JAX package's flags (and ``--photo-fraction``) and
    passes each one the trainer takes, with the device."""
    from elvis_tpu_torch.train import cli

    seen = {}
    for name in ("srnet_student", "deblur"):
        real = cli._TRAINERS[name]

        def fake(steps, ckpt_dir, _real=real, _name=name, **kw):
            assert set(kw) <= set(__import__("inspect").signature(_real).parameters)
            seen[_name] = (steps, ckpt_dir, kw)

        fake.__signature__ = __import__("inspect").signature(real)
        monkeypatch.setitem(cli._TRAINERS, name, fake)
    argv = ["--steps", "7", "--ckpt-dir", "ck", "--lr", "1e-3", "--val-every", "3",
            "--features", "32", "--num-convs", "4", "--distill-weight", "0.5",
            "--teacher-dihedral", "--extra-teacher", "a", "--extra-teacher", "b",
            "--sensor-fraction", "0.2", "--jpeg-gt-fraction", "0.3", "--photos", "china,wood",
            "--photo-fraction", "0"]
    assert cli.main(["srnet_student", *argv], device="cpu") == 0
    steps, ckpt, kw = seen["srnet_student"]
    assert (steps, ckpt) == (7, "ck") and kw == dict(
        lr=1e-3, val_every=3, features=32, num_convs=4, distill_weight=0.5,
        sensor_fraction=0.2, jpeg_gt_fraction=0.3, photo_fraction=0.0,
        photos=("china", "wood"), teacher_dihedral=True, extra_teachers=("a", "b"),
        device="cpu")
    assert cli.main(["deblur", *argv], device="cpu") == 0
    assert seen["deblur"][2] == dict(lr=1e-3, val_every=3, photo_fraction=0.0, device="cpu")


def test_trainers_run_on_the_card_only(tmp_path, monkeypatch):
    from elvis_tpu_torch.train.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["deblur", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_codec_noise_at_jax_draws_equals_jax():
    """``codec_noise`` is deterministic given its draws: at JAX's own QP and
    apply draws the port's quantizer gives JAX's frames."""
    from elvis_tpu.train.data import codec_noise as jnoise
    from elvis_tpu_torch.train.data import codec_noise_at

    x = (np.random.default_rng(9).random((8, 32, 32, 3)) * 255).astype(np.float32)
    for seed, args in ((0, (8, 16.0, 38.0, 0.7)), (3, (8, 14.0, 20.0, 1.0))):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        n = x.shape[0]
        qp = np.asarray(jax.random.uniform(k1, (n, 1, 1, 1, 1, 1), minval=args[1],
                                           maxval=args[2])).reshape(n)
        apply = np.asarray(jax.random.bernoulli(k2, args[3], (n, 1, 1, 1))).reshape(n)
        want = np.asarray(jnoise(key, jnp.asarray(x), *args))
        got = codec_noise_at(torch.from_numpy(x), torch.from_numpy(qp),
                             torch.from_numpy(apply), args[0]).numpy()
        assert (np.abs(got - want) > 1e-3).mean() <= 1e-4
        np.testing.assert_array_equal(got[~apply], x[~apply])


def _stats(x: np.ndarray):
    """(mean, std, high-frequency energy: mean |horizontal difference|)."""
    return np.asarray([x.mean(), x.std(), np.abs(np.diff(x, axis=2)).mean()])


@pytest.mark.parametrize("name", ["synthetic_frames", "natural_frames", "structured_frames",
                                  "dead_leaves", "fractal_noise"])
def test_procedural_sources_match_jax_statistics(name):
    from elvis_tpu.train import data as jdata
    from elvis_tpu_torch.train import data as tdata

    shape = (16, 32, 32)
    jruns = [np.asarray(getattr(jdata, name)(jax.random.PRNGKey(s), *shape)) for s in range(4)]
    truns = []
    for s in range(4):
        out = getattr(tdata, name)(torch.Generator().manual_seed(s), *shape)
        assert out.shape == shape + (3,) and out.dtype == torch.float32
        truns.append(out.numpy())
    if name != "fractal_noise":
        assert min(r.min() for r in truns) >= 0.0 and max(r.max() for r in truns) <= 255.0
    js = np.stack([_stats(r) for r in jruns])
    ts = np.stack([_stats(r) for r in truns])
    bound = np.maximum(3.0 * js.std(axis=0) / np.sqrt(2.0), 0.06 * np.abs(js.mean(axis=0)))
    assert np.all(np.abs(ts.mean(axis=0) - js.mean(axis=0)) <= bound), \
        (ts.mean(axis=0), js.mean(axis=0), bound)


def test_augmentations_and_batches():
    """Shapes, ranges and what each augmentation does, as the JAX package's
    tests hold its own: the photometric jitter stays in range, the sensor
    grain hits about ``fraction`` of the samples (the rest pass unchanged)
    and is stronger in the shadows; the SR pair, the clips."""
    from elvis_tpu_torch.train import data

    g = torch.Generator().manual_seed(0)
    flat = torch.full((32, 16, 16, 3), 128.0)
    out = data.sensor_augment(g, flat, 0.5)
    noisy = (out.std(dim=(1, 2, 3)) > 0.1).sum()
    assert 6 <= int(noisy) <= 26
    clean = out[out.std(dim=(1, 2, 3)) <= 0.1]
    assert torch.equal(clean, torch.full_like(clean, 128.0))
    dark = data.sensor_augment(torch.Generator().manual_seed(1), torch.full((64, 16, 16, 3), 20.0),
                               1.0)
    bright = data.sensor_augment(torch.Generator().manual_seed(1),
                                 torch.full((64, 16, 16, 3), 235.0), 1.0)
    assert dark.std() > bright.std()
    jit = data.photometric_augment(g, torch.rand((8, 8, 8, 3), generator=g) * 255)
    assert 0.0 <= float(jit.min()) and float(jit.max()) <= 255.0
    lo, hi = data.synthetic_sr_batch(g, 4, 32)
    assert lo.shape == (4, 16, 16, 3) and hi.shape == (4, 32, 32, 3)
    clip = data.synthetic_video_batch(g, 5, 16, 24)
    assert clip.shape == (5, 16, 24, 3)
    pan = data.natural_video_batch(g, 4, 16, 24)
    assert pan.shape == (4, 16, 24, 3) and not torch.equal(pan[0], pan[-1])
    pool = torch.rand((3, 16 + 2 * 3 * 4, 24 + 2 * 3 * 4, 3), generator=g) * 255
    assert data.photo_video_batch(g, pool, 4, 16, 24).shape == (4, 16, 24, 3)
    x = data.structured_frames(g, 8, 64, 64).numpy()
    assert all(x[i].std() > 15 for i in range(8)) and np.abs(np.diff(x, axis=2)).mean() > 4.0


def test_photo_pool_equals_jax_and_names_a_missing_package(monkeypatch):
    from elvis_tpu.train.data import photo_patch_pool as jpool
    from elvis_tpu_torch.train import data as tdata

    for args in ((32, True, 16, 0), (32, False, 8, 1, ("wood", "sky"))):
        np.testing.assert_array_equal(tdata.photo_patch_pool(*args), jpool(*args))
    tdata.photo_patch_pool.cache_clear()
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name.startswith("PIL"):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.setattr("importlib.import_module", lambda name: no_pil(name))
    with pytest.raises(ImportError, match="needs PIL"):
        tdata.photo_patch_pool(32, True, 4, 5)
