"""Restorer training CLI (port of ``elvis_tpu.train.cli``):
``python -m elvis_tpu_torch.train.cli srnet_student --steps N ...``.

The SR trainers train a 2x upsampler THROUGH the progressive restoration
loop on procedurally generated degradation pairs (``train.data``), the
deblur trainer the DeblurUNet on adaptive-blur pairs. Checkpoints are the
port's ``.npz`` weights files (``<ckpt_dir>/<tag>.npz``), the format
``models.io.load_srnet`` / ``load_deblur`` and the pipeline's
``*_params_path`` fields read, beside the JAX package's
``<tag>.meta.json`` sidecars.

The models start from torch's initialisation with the output tail at zero,
so an SR net starts exactly at progressive Lanczos (clamped) and the deblur
net at the identity; tests start them from the JAX package's initial
parameters instead.

The diffusion trainer trains the conditional UNet through
``DiffusionRestorer.loss`` on heavy adaptive-blur pairs, the inpaint trainer
the InpaintNet over the temporal fill's seed, the perceptual trainer the
LPIPS backbone by a 2AFC ranking hinge, the saliency trainer the SaliencyNet
against the motion-contrast teacher. The photo pool (``photo_fraction``,
``val_every``) needs PIL and the packages that ship the photographs
(``train.data.photo_patch_pool``); without them it raises.
``--photo-fraction 0`` trains on the procedural sources alone (the inpaint,
perceptual and saliency trainers take the fraction too: the JAX package
always mixes photographs in there, at 0.5, 0.5 and 0.3).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from elvis_tpu_torch.device import resolve_device

__all__ = [
    "train_srnet",
    "train_srnet_compact",
    "train_srnet_student",
    "train_srnet_4k",
    "train_deblur",
    "train_diffusion",
    "train_inpaint",
    "train_perceptual",
    "train_saliency",
    "main",
]

MAX_LEVEL = 3  # the SR loop's static stage count: factors up to 8x
DATA_SEED = 1  # the batches' generator (the JAX package's PRNGKey(1))


def _mesh(device_type: str):
    """With at least two devices and an even count, ``data n/2 x tensor
    2``; otherwise one data axis over every device."""
    from elvis_tpu_torch.parallel import devices, make_mesh

    n = len(devices(device_type))
    if n >= 2 and n % 2 == 0:
        return make_mesh((("data", n // 2), ("tensor", 2)), device_type=device_type)
    return make_mesh(device_type=device_type)


def _zero_tail(model: nn.Module) -> nn.Module:
    """The output conv at zero (weight and bias), as the flax models'
    ``zeros`` init: the net starts at its base (Lanczos, or the input)."""
    with torch.no_grad():
        model.tail.weight.zero_()
        model.tail.bias.zero_()
    return model


def _sr_upsampler(model: nn.Module) -> Callable:
    """A frozen SR net as the loop's 2x upsampler (phase form too), with
    autograd off by its parameters, not by inference mode: its outputs may
    enter a graph that trains another net."""

    def up(f):
        return model(f.float(), phase_output=False)

    up.phase_fn = lambda f: model(f.float(), phase_output=True)
    return up


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(-10.0 * torch.log10(torch.mean((a - b) ** 2) / 255.0**2))


def _ema_and_val(trainer, ema_decay: float, val_every: int, tag: str, val_psnr, baseline):
    """EMA of the parameters and held-out-validation checkpoint selection,
    as in the JAX package: ``(on_step, finish)`` callbacks."""
    ema = {n: p.clone() for n, p in trainer.params().items()}
    best = {"psnr": -1.0, "params": None}

    def on_step(step: int, steps: int):
        with torch.no_grad():
            for n, p in trainer.params().items():
                ema[n] = ema_decay * ema[n] + (1.0 - ema_decay) * p
        if val_every > 0 and (step % val_every == 0 or step == steps - 1) and step > 0:
            vp_now = val_psnr(ema)
            mark = ""
            if vp_now > best["psnr"]:
                best["psnr"], best["params"] = vp_now, {n: p.clone() for n, p in ema.items()}
                mark = " *best"
            print(f"{tag} step {step}: val psnr {vp_now:.3f}{baseline}{mark}", flush=True)

    def finish():
        if best["params"] is not None:
            trainer.set_params(best["params"])
            print(f"{tag}: saving best-EMA checkpoint (val psnr {best['psnr']:.3f})",
                  flush=True)

    return on_step, finish


def _loop(trainer, make_batch, steps: int, tag: str, log_every: int, on_step, dev) -> None:
    """The training loop: a step per batch, the loss at ``log_every``
    (a host synchronisation), and each step's time (CUDA events on a card,
    read once at the end) in ``trainer.step_ms``; the loss curve in
    ``trainer.losses``."""
    cuda = dev.type == "cuda"
    marks, losses = [], []
    t0 = time.time()
    for step in range(steps):
        marks.append(torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter())
        if cuda:
            marks[-1].record()
        loss = trainer.step(make_batch())
        losses.append(loss)
        on_step(step, steps)
        if step % log_every == 0 or step == steps - 1:
            print(f"{tag} step {step}: loss {float(loss):.6f} ({time.time() - t0:.0f}s)",
                  flush=True)
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize(dev)
        marks.append(end)
        trainer.step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks.append(time.perf_counter())
        trainer.step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    trainer.losses = [float(x) for x in losses]


def _train_sr(model: nn.Module, tag: str, steps: int, ckpt_dir: Optional[str], lr: float,
              batch: int, patch: int, log_every: int, block_size: int,
              natural_fraction: float = 0.75, photo_fraction: float = 0.0,
              ema_decay: float = 0.999, val_every: int = 0,
              photos: tuple = ("china", "flower"), weight_decay: float = 1e-4,
              structured_fraction: float = 0.0, teacher_up=None,
              distill_weight: float = 1.0, frozen_prefix_up=None,
              sensor_fraction: float = 0.0, jpeg_gt_fraction: float = 0.0,
              device: "str | torch.device" = "cuda"):
    """Train a 2x upsampler THROUGH the progressive restoration loop: the
    loss is ``|| progressive_restore(adaptive_downsample(clean)) - clean ||``
    (mean square / 255^2), plus ``distill_weight`` times the distance to
    ``teacher_up``'s loop output when a teacher is given. ``model`` starts
    from its current parameters. ``frozen_prefix_up`` trains ``model`` as
    the FINAL stage only, every earlier stage running the frozen upsampler
    (the 4K finisher). The data: natural-statistics content (a
    ``natural_fraction`` of samples, else the band-limited synthetic
    family), ``structured_fraction`` of the text / architecture family,
    ``photo_fraction`` of real-photo patches, photometric jitter, the
    optional noisy and JPEG ground truths, codec noise on the input.
    Warmup-cosine AdamW (the first step at learning rate 0), EMA, and with
    ``val_every`` the held-out photo strip picking the saved checkpoint.
    Draws come from ``torch.Generator(device).manual_seed(DATA_SEED)``."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x, progressive_restore
    from elvis_tpu_torch.train.data import (
        _bernoulli, _randint, codec_noise, natural_frames, photo_patch_pool,
        photometric_augment, sensor_augment, structured_frames, synthetic_frames)
    from elvis_tpu_torch.train.trainer import Trainer, warmup_cosine_decay_schedule

    dev = resolve_device(device)
    model.to(dev)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    pool = (torch.as_tensor(photo_patch_pool(patch, True, 2048, 0, photos), device=dev)
            if photo_fraction > 0 else None)

    @torch.no_grad()
    def make_batch():
        shape = (batch, 1, 1, 1)
        natural = _bernoulli(gen, natural_fraction, shape)
        clean = torch.where(natural, natural_frames(gen, batch, patch, patch),
                            synthetic_frames(gen, batch, patch, patch))
        if structured_fraction > 0:
            clean = torch.where(_bernoulli(gen, structured_fraction, shape),
                                structured_frames(gen, batch, patch, patch), clean)
        if pool is not None:
            photo = pool[_randint(gen, 0, pool.shape[0], (batch,))]
            clean = torch.where(_bernoulli(gen, photo_fraction, shape), photo, clean)
        clean = photometric_augment(gen, clean)
        if sensor_fraction > 0:
            clean = sensor_augment(gen, clean, sensor_fraction)
        if jpeg_gt_fraction > 0:
            clean = codec_noise(gen, clean, block_size, 14.0, 30.0, jpeg_gt_fraction)
        scores = torch.rand((batch, patch // block_size, patch // block_size), generator=gen,
                            device=dev)
        degraded, levels = adaptive_downsample(clean, scores, block_size)
        degraded = codec_noise(gen, degraded, block_size)
        if teacher_up is not None:
            teacher = progressive_restore(degraded, levels, block_size, upsample_fn=teacher_up,
                                          max_level=MAX_LEVEL)
            return clean, degraded, levels, teacher
        return clean, degraded, levels

    def up_for(p):
        trainee = lambda f: functional_call(model, p, (f,))  # noqa: E731
        if frozen_prefix_up is None:
            return trainee
        return [frozen_prefix_up] * (MAX_LEVEL - 1) + [trainee]

    def loss_fn(p, data):
        clean, degraded, levels = data[:3]
        restored = progressive_restore(degraded, levels, block_size, upsample_fn=up_for(p),
                                       max_level=MAX_LEVEL)
        loss = torch.mean((restored - clean) ** 2) / 255.0**2
        if teacher_up is not None:
            loss = loss + distill_weight * torch.mean((restored - data[3]) ** 2) / 255.0**2
        return loss

    schedule = warmup_cosine_decay_schedule(0.0, lr, min(100, steps // 10 + 1), steps)
    trainer = Trainer(loss_fn, model, mesh=_mesh(dev.type),
                      learning_rate=schedule, ckpt_dir=ckpt_dir, weight_decay=weight_decay,
                      device=dev)

    val_psnr, baseline = None, ""
    if val_every > 0:
        # the 16 most DETAILED patches (gradient energy) of a wide draw from
        # the held-out strip: a smooth strip leaves the selector no headroom
        vp = 128
        cand = photo_patch_pool(vp, False, 96, 1, photos)
        g = np.abs(np.diff(cand, axis=1)).mean(axis=(1, 2, 3)) + np.abs(
            np.diff(cand, axis=2)).mean(axis=(1, 2, 3))
        val_clean = torch.as_tensor(cand[np.argsort(-g)[:16]], device=dev)
        vgen = torch.Generator(device=dev).manual_seed(123)
        val_scores = torch.rand((16, vp // block_size, vp // block_size), generator=vgen,
                                device=dev)
        val_degraded, val_levels = adaptive_downsample(val_clean, val_scores, block_size)

        @torch.no_grad()
        def val_psnr(p):
            return _psnr(progressive_restore(val_degraded, val_levels, block_size,
                                             upsample_fn=up_for(p), max_level=MAX_LEVEL),
                         val_clean)

        with torch.no_grad():
            lz = _psnr(progressive_restore(val_degraded, val_levels, block_size,
                                           upsample_fn=lanczos_upsample_2x,
                                           max_level=MAX_LEVEL), val_clean)
        print(f"{tag} val lanczos psnr: {lz:.3f}", flush=True)
        baseline = f" (lanczos {lz:.3f})"

    on_step, finish = _ema_and_val(trainer, ema_decay, val_every, tag, val_psnr, baseline)
    _loop(trainer, make_batch, steps, tag, log_every, on_step, dev)
    finish()
    trainer.sync_model()
    trainer.save(tag)
    return trainer


# the default corpus: the two sklearn photos PLUS the texture photographs
# and the structured text / architecture family
_R4_PHOTOS = ("china", "flower", "wood", "tile", "marble", "metal",
              "sky", "grass", "fur", "darkwood", "silver", "skin")
_R4_STRUCTURED = 0.18


def train_srnet(steps: int, ckpt_dir: Optional[str], lr: float = 1e-4, batch: int = 16,
                patch: int = 64, log_every: int = 50, block_size: int = 8,
                photo_fraction: float = 0.5, val_every: int = 0, photos: tuple = _R4_PHOTOS,
                structured_fraction: float = _R4_STRUCTURED, sensor_fraction: float = 0.0,
                jpeg_gt_fraction: float = 0.0, device: "str | torch.device" = "cuda"):
    """RRDB ``SRNet`` through the loop."""
    from elvis_tpu_torch.models import SRNet

    return _train_sr(_zero_tail(SRNet()), "srnet", steps, ckpt_dir, lr, batch, patch,
                     log_every, block_size, photo_fraction=photo_fraction,
                     val_every=val_every, photos=photos,
                     structured_fraction=structured_fraction, sensor_fraction=sensor_fraction,
                     jpeg_gt_fraction=jpeg_gt_fraction, device=device)


def train_srnet_compact(steps: int, ckpt_dir: Optional[str], lr: float = 4e-4,
                        batch: int = 16, patch: int = 64, log_every: int = 50,
                        block_size: int = 8, photo_fraction: float = 0.5, val_every: int = 0,
                        photos: tuple = _R4_PHOTOS,
                        structured_fraction: float = _R4_STRUCTURED,
                        sensor_fraction: float = 0.0, jpeg_gt_fraction: float = 0.0,
                        device: "str | torch.device" = "cuda"):
    """SRNetCompact (128 x 5) through the loop."""
    from elvis_tpu_torch.models import SRNetCompact

    return _train_sr(_zero_tail(SRNetCompact()), "srnet_compact", steps, ckpt_dir, lr, batch,
                     patch, log_every, block_size, photo_fraction=photo_fraction,
                     val_every=val_every, photos=photos,
                     structured_fraction=structured_fraction, sensor_fraction=sensor_fraction,
                     jpeg_gt_fraction=jpeg_gt_fraction, device=device)


def _teacher_path(ckpt_dir: Optional[str], name: str) -> str:
    """A freshly retrained teacher in ``ckpt_dir`` wins; else the shipped one."""
    from elvis_tpu_torch.models.io import weights_path

    path = os.path.join(ckpt_dir or "checkpoints", f"{name}.npz")
    if os.path.isfile(path):
        return path
    path = weights_path(name)
    if path is None:
        raise FileNotFoundError(f"teacher weights {name} missing: train the tiers first")
    return path


def train_srnet_student(steps: int, ckpt_dir: Optional[str], lr: float = 2e-4,
                        batch: int = 16, patch: int = 64, log_every: int = 50,
                        block_size: int = 8, photo_fraction: float = 0.5,
                        val_every: int = 0, features: int = 128, num_convs: int = 10,
                        distill_weight: float = 1.0,
                        structured_fraction: float = _R4_STRUCTURED,
                        photos: tuple = _R4_PHOTOS, teacher_dihedral: bool = False,
                        extra_teachers: tuple = (), sensor_fraction: float = 0.0,
                        jpeg_gt_fraction: float = 0.0, device: "str | torch.device" = "cuda"):
    """Distill the quality tiers (compact + RRDB + large, averaged) into ONE
    SRNetCompact-family student of ``features x num_convs``, against ground
    truth AND the teachers' loop output. ``teacher_dihedral`` averages every
    teacher forward over the 8 dihedral transforms; ``extra_teachers`` adds
    earlier students' weights files to the average. ``distill_weight=0``
    trains the student alone. The architecture and teachers land in
    ``srnet_student.meta.json``."""
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.models.io import load_srnet

    dev = resolve_device(device)
    student = _zero_tail(SRNetCompact(features=features, num_convs=num_convs))
    common = dict(photo_fraction=photo_fraction, val_every=val_every, photos=photos,
                  structured_fraction=structured_fraction, sensor_fraction=sensor_fraction,
                  device=dev)

    def write_meta(meta):
        if ckpt_dir:
            with open(os.path.join(ckpt_dir, "srnet_student.meta.json"), "w") as fh:
                json.dump(meta, fh)

    if distill_weight == 0.0:
        trainer = _train_sr(student, "srnet_student", steps, ckpt_dir, lr, batch, patch,
                            log_every, block_size, **common)
        write_meta({"features": features, "num_convs": num_convs, "teachers": [],
                    "distill_weight": 0.0})
        return trainer

    names = ["srnet_compact", "srnet", "srnet_large"]
    paths = [_teacher_path(ckpt_dir, n) for n in names]
    for path in extra_teachers:  # an earlier generation's student
        paths.append(path if path.endswith(".npz") else f"{path.rstrip('/')}.npz")
        names.append(path)
    ups = [_sr_upsampler(load_srnet(p, dev)) for p in paths]
    k = float(len(ups))

    def mean_up(f):
        return sum(up(f) for up in ups) / k

    if teacher_dihedral:
        def teacher_up(f):
            acc = 0.0
            for rot in range(4):
                for flip in (False, True):
                    g = torch.rot90(f, rot, dims=(1, 2))
                    if flip:
                        g = torch.flip(g, (2,))
                    y = mean_up(g)
                    if flip:
                        y = torch.flip(y, (2,))
                    acc = acc + torch.rot90(y, -rot, dims=(1, 2))
            return acc / 8.0
    else:
        teacher_up = mean_up
        # averaging commutes with the final interleave: phase form too
        teacher_up.phase_fn = lambda f: sum(up.phase_fn(f) for up in ups) / k

    trainer = _train_sr(student, "srnet_student", steps, ckpt_dir, lr, batch, patch,
                        log_every, block_size, teacher_up=teacher_up,
                        distill_weight=distill_weight, jpeg_gt_fraction=jpeg_gt_fraction,
                        **common)
    write_meta({"features": features, "num_convs": num_convs, "teachers": names,
                "teacher_dihedral": teacher_dihedral, "distill_weight": distill_weight})
    return trainer


def train_srnet_4k(steps: int, ckpt_dir: Optional[str], lr: float = 4e-4, batch: int = 16,
                   patch: int = 64, log_every: int = 50, block_size: int = 8,
                   photo_fraction: float = 0.5, val_every: int = 0, features: int = 64,
                   num_convs: int = 5, structured_fraction: float = _R4_STRUCTURED,
                   photos: tuple = _R4_PHOTOS, device: "str | torch.device" = "cuda"):
    """The 4K finisher: a narrow ``features x num_convs`` net trained as the
    loop's FINAL 2x stage only, over the serving tier (``srnet_compact``)
    frozen on the earlier stages. The architecture lands in
    ``srnet_4k.meta.json``."""
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.models.io import load_srnet

    dev = resolve_device(device)
    base = load_srnet(_teacher_path(ckpt_dir, "srnet_compact"), dev)
    trainer = _train_sr(_zero_tail(SRNetCompact(features=features, num_convs=num_convs)),
                        "srnet_4k", steps, ckpt_dir, lr, batch, patch, log_every, block_size,
                        photo_fraction=photo_fraction, val_every=val_every, photos=photos,
                        structured_fraction=structured_fraction,
                        frozen_prefix_up=lambda f: base(f.float()), device=dev)
    if ckpt_dir:
        with open(os.path.join(ckpt_dir, "srnet_4k.meta.json"), "w") as fh:
            json.dump({"features": features, "num_convs": num_convs,
                       "prefix": "srnet_compact"}, fh)
    return trainer


def deblur_loss(model: nn.Module, block_size: int = 8) -> Callable:
    """``loss_fn(params, (clean, degraded, levels))``: the deblur net's mean
    square error / 255^2 under ``params``."""

    def loss_fn(p, data):
        clean, degraded, levels = data
        pred = functional_call(model, p, (degraded, levels, block_size))
        return torch.mean((pred - clean) ** 2) / 255.0**2

    return loss_fn


def train_deblur(steps: int, ckpt_dir: Optional[str], lr: float = 2e-4, batch: int = 8,
                 patch: int = 64, max_rounds: int = 10, log_every: int = 50,
                 photo_fraction: float = 0.0, val_every: int = 0, ema_decay: float = 0.999,
                 device: "str | torch.device" = "cuda"):
    """DeblurUNet on adaptive-blur pairs (half natural, half synthetic
    content; ``photo_fraction`` of photo patches), constant learning rate,
    EMA and the held-out photo strip as ``_train_sr``. Records the trained
    ``max_strength`` in ``deblur.meta.json``."""
    from elvis_tpu_torch.degrade import adaptive_blur
    from elvis_tpu_torch.models import DeblurUNet
    from elvis_tpu_torch.train.data import (
        _bernoulli, _randint, natural_frames, photo_patch_pool, synthetic_frames)
    from elvis_tpu_torch.train.trainer import Trainer

    b = 8
    dev = resolve_device(device)
    model = _zero_tail(DeblurUNet(max_strength=float(max_rounds))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    pool = (torch.as_tensor(photo_patch_pool(patch, True, 2048, 0), device=dev)
            if photo_fraction > 0 else None)

    @torch.no_grad()
    def make_batch():
        shape = (batch, 1, 1, 1)
        natural = _bernoulli(gen, 0.5, shape)
        clean = torch.where(natural, natural_frames(gen, batch, patch, patch),
                            synthetic_frames(gen, batch, patch, patch))
        if pool is not None:
            photo = pool[_randint(gen, 0, pool.shape[0], (batch,))]
            clean = torch.where(_bernoulli(gen, photo_fraction, shape), photo, clean)
        scores = torch.rand((batch, patch // b, patch // b), generator=gen, device=dev)
        degraded, levels = adaptive_blur(clean, scores, b, max_rounds)
        return clean, degraded, levels

    trainer = Trainer(deblur_loss(model, b), model, mesh=_mesh(dev.type), learning_rate=lr,
                      ckpt_dir=ckpt_dir, device=dev)
    val_psnr, baseline = None, ""
    if val_every > 0:
        vp = 128
        val_clean = torch.as_tensor(photo_patch_pool(vp, False, 16, 1), device=dev)
        vgen = torch.Generator(device=dev).manual_seed(123)
        val_scores = torch.rand((16, vp // b, vp // b), generator=vgen, device=dev)
        val_degraded, val_levels = adaptive_blur(val_clean, val_scores, b, max_rounds)
        print(f"deblur val blurred-input psnr: {_psnr(val_degraded, val_clean):.3f}",
              flush=True)

        @torch.no_grad()
        def val_psnr(p):
            return _psnr(functional_call(model, p, (val_degraded, val_levels, b)), val_clean)

    on_step, finish = _ema_and_val(trainer, ema_decay, val_every, "deblur", val_psnr, baseline)
    _loop(trainer, make_batch, steps, "deblur", log_every, on_step, dev)
    finish()
    trainer.sync_model()
    trainer.save("deblur")
    if ckpt_dir:
        # the conditioning contract: the trained strength normalisation
        with open(os.path.join(ckpt_dir, "deblur.meta.json"), "w") as fh:
            json.dump({"max_strength": float(max_rounds)}, fh)
    return trainer


def _one_device(dev: torch.device):
    """A mesh of ``dev`` alone: the inpaint and saliency batches are one clip
    whose frames the nets see together (temporal context), so splitting it
    over data shards would cut that context; the JAX package's compiled step
    computes the global function whatever the layout."""
    from elvis_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev], device_type=dev.type)


def inpaint_loss(model: nn.Module, block_size: int = 8) -> Callable:
    """``loss_fn(params, (clean, seeded, mask))``: the InpaintNet's mean
    square error / 255^2 against the clean clip, from the propagation seed."""

    def loss_fn(p, data):
        clean, seeded, mask = data
        pred = functional_call(model, p, (seeded, mask, block_size))
        return torch.mean((pred - clean) ** 2) / 255.0**2

    return loss_fn


def train_inpaint(steps: int, ckpt_dir: Optional[str], lr: float = 2e-4, frames: int = 8,
                  patch: int = 64, log_every: int = 50, photo_fraction: float = 0.5,
                  device: "str | torch.device" = "cuda"):
    """InpaintNet on the input it sees at inference: a panning clip (a
    ``photo_fraction`` chance of a pan over a real photograph, else
    natural-statistics content), a quarter of its blocks holed, the holes
    pre-filled by the temporal propagation fill (``restore_removal_temporal``,
    as the 'neural' backend seeds the net), so the net learns the residual
    polish over propagation. Constant learning rate, no mesh."""
    from elvis_tpu_torch.core.blocks import upsample_map
    from elvis_tpu_torch.models import InpaintNet
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal
    from elvis_tpu_torch.train.data import (
        _bernoulli, natural_video_batch, photo_patch_pool, photo_video_batch)
    from elvis_tpu_torch.train.trainer import Trainer

    b = 8
    dev = resolve_device(device)
    model = InpaintNet().to(dev)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    max_pan = 3
    pool = (torch.as_tensor(photo_patch_pool(patch + 2 * max_pan * frames, True, 512, 2),
                            device=dev) if photo_fraction > 0 else None)

    @torch.no_grad()
    def make_batch():
        if pool is not None and bool(_bernoulli(gen, photo_fraction, ())):
            clip = photo_video_batch(gen, pool, frames, patch, patch, max_pan)
        else:
            clip = natural_video_batch(gen, frames, patch, patch)
        mask = (torch.rand((frames, patch // b, patch // b), generator=gen, device=dev)
                < 0.25).to(torch.int8)
        holed = torch.where(upsample_map(mask.bool(), b)[..., None], 0.0, clip)
        return clip, restore_removal_temporal(holed, mask, b), mask

    trainer = Trainer(inpaint_loss(model, b), model, mesh=_one_device(dev), learning_rate=lr,
                      ckpt_dir=ckpt_dir, device=dev)
    _loop(trainer, make_batch, steps, "inpaint", log_every, lambda step, steps_: None, dev)
    trainer.sync_model()
    trainer.save("inpaint")
    return trainer


def diffusion_loss(d: nn.Module) -> Callable:
    """``loss_fn(params, (clean, degraded, t, gamma, noise))``: the
    restorer's ``loss`` under the UNet parameters ``params``, at the batch's
    own timesteps, mix weights and noise (drawn in the batch maker, so a
    data-sharded step splits them with their samples)."""

    def loss_fn(p, data):
        clean, degraded, t, gamma, noise = data
        return d.loss(clean, degraded, t=t, gamma=gamma, noise=noise, params=p)

    return loss_fn


def train_diffusion(steps: int, ckpt_dir: Optional[str], lr: float = 2e-4, batch: int = 16,
                    patch: int = 64, max_rounds: int = 10, log_every: int = 50,
                    photo_fraction: float = 0.5, val_every: int = 0, ema_decay: float = 0.999,
                    device: "str | torch.device" = "cuda"):
    """The conditional diffusion restorer (the InstantIR slot): x0-residual
    prediction conditioned on the adaptively blurred frame. The blur
    strengths are biased HEAVY (scores ~ sqrt(U), median round 7: the regime
    where the slot must beat the classical restore); a ``photo_fraction`` of
    photo patches, photometric jitter; constant learning rate on the DP x TP
    mesh, EMA, and with ``val_every`` the SAMPLED restoration (4 DDIM steps)
    on the held-out heavy-blur photo strip picks the saved checkpoint. The
    UNet's weights land in ``<ckpt_dir>/diffusion.npz`` (``load_diffusion``)."""
    import copy

    from elvis_tpu_torch.degrade import adaptive_blur
    from elvis_tpu_torch.models import DiffusionRestorer
    from elvis_tpu_torch.train.data import (
        _bernoulli, _randint, natural_frames, photo_patch_pool, photometric_augment)
    from elvis_tpu_torch.train.trainer import Trainer

    b = 8
    dev = resolve_device(device)
    d = DiffusionRestorer().to(dev)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    pool = (torch.as_tensor(photo_patch_pool(patch, True, 2048, 0), device=dev)
            if photo_fraction > 0 else None)

    @torch.no_grad()
    def make_batch():
        clean = natural_frames(gen, batch, patch, patch)
        if pool is not None:
            photo = pool[_randint(gen, 0, pool.shape[0], (batch,))]
            clean = torch.where(_bernoulli(gen, photo_fraction, (batch, 1, 1, 1)), photo, clean)
        clean = photometric_augment(gen, clean)
        # heavy-blur bias: scores ~ sqrt(U), median round 7
        scores = torch.sqrt(torch.rand((batch, patch // b, patch // b), generator=gen,
                                       device=dev))
        degraded, _ = adaptive_blur(clean, scores, b, max_rounds)
        t = torch.randint(1, d.num_train_steps, (batch,), generator=gen, device=dev)
        gamma = torch.rand((batch, 1, 1, 1), generator=gen, device=dev)
        noise = torch.randn(clean.shape, generator=gen, device=dev)
        return clean, degraded, t, gamma, noise

    trainer = Trainer(diffusion_loss(d), d.unet, mesh=_mesh(dev.type), learning_rate=lr,
                      ckpt_dir=ckpt_dir, device=dev)
    val_psnr, baseline = None, ""
    if val_every > 0:
        vp = 128
        val_clean = torch.as_tensor(photo_patch_pool(vp, False, 16, 1), device=dev)
        vgen = torch.Generator(device=dev).manual_seed(123)
        # heavy-blur validation: the regime the slot must win
        val_scores = 0.5 + 0.5 * torch.rand((16, vp // b, vp // b), generator=vgen, device=dev)
        val_degraded, _ = adaptive_blur(val_clean, val_scores, b, max_rounds)
        print(f"diffusion val blurred-input psnr: {_psnr(val_degraded, val_clean):.3f}",
              flush=True)
        val_d = copy.deepcopy(d)

        def val_psnr(p):
            val_d.unet.load_state_dict(p)
            out = val_d.sample(val_degraded, steps=4,
                               generator=torch.Generator(device=dev).manual_seed(5))
            return _psnr(out, val_clean)

    on_step, finish = _ema_and_val(trainer, ema_decay, val_every, "diffusion", val_psnr,
                                   baseline)
    _loop(trainer, make_batch, steps, "diffusion", log_every, on_step, dev)
    finish()
    trainer.sync_model()
    trainer.save("diffusion")
    return trainer


def perceptual_endpoints(clean: torch.Tensor, noise: torch.Tensor, qp: torch.Tensor,
                         apply: torch.Tensor) -> torch.Tensor:
    """The ranking ladders' heavy ends (``(4,B,H,W,3)``): blur (two 5-tap
    sigma-2 gaussians), area-down 4x / linear-up, additive noise (40 grey
    levels x ``noise``, clipped), and codec artifacts (``codec_noise_at``
    at ``qp``, where ``apply``)."""
    from elvis_tpu_torch.ops.filter import gaussian_blur
    from elvis_tpu_torch.ops.resize import resize
    from elvis_tpu_torch.train.data import codec_noise_at

    h, w = clean.shape[1], clean.shape[2]
    blur = gaussian_blur(gaussian_blur(clean, 5, 2.0), 5, 2.0)
    down = resize(resize(clean, (h // 4, w // 4), method="area"), (h, w), method="linear")
    noisy = torch.clamp(clean + 40.0 * noise, 0, 255)
    return torch.stack([blur, down, noisy, codec_noise_at(clean, qp, apply)])


def perceptual_loss(model: nn.Module, margin: float = 0.05) -> Callable:
    """``loss_fn(params, (clean, weak, strong))``: the 2AFC ranking hinge
    (``d(clean, weak) + margin <= d(clean, strong)``, the LPIPS formula on
    the backbone under ``params``) plus the identity anchor
    ``d(clean, clean)``."""
    from elvis_tpu_torch.metrics.perceptual import lpips_pairwise

    def loss_fn(p, data):
        clean, weak, strong = data
        net = lambda x: functional_call(model, p, (x,))  # noqa: E731
        d_weak = lpips_pairwise(net, clean, weak)
        d_strong = lpips_pairwise(net, clean, strong)
        rank = torch.clamp(margin + d_weak - d_strong, min=0.0).mean()
        return rank + lpips_pairwise(net, clean, clean).mean()

    return loss_fn


def train_perceptual(steps: int, ckpt_dir: Optional[str], lr: float = 1e-4, batch: int = 12,
                     patch: int = 64, log_every: int = 50, photo_fraction: float = 0.5,
                     device: "str | torch.device" = "cuda"):
    """LPIPS-style 2AFC ranking training of the PerceptualNet backbone: for
    a clean patch (a ``photo_fraction`` of photo patches, else natural
    content) and two strengths ``t1 < t2`` along a path to one of four heavy
    ends (``perceptual_endpoints``), the metric must rank d(clean, weak) <
    d(clean, strong) by a margin; the identity anchor keeps d(x, x) at ~0.
    Constant learning rate on the DP x TP mesh."""
    from elvis_tpu_torch.metrics.perceptual import PerceptualNet
    from elvis_tpu_torch.train.data import (
        _bernoulli, _normal, _randint, _uniform, natural_frames, photo_patch_pool)
    from elvis_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    model = PerceptualNet().to(dev)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    pool = (torch.as_tensor(photo_patch_pool(patch, True, 1024, 3), device=dev)
            if photo_fraction > 0 else None)

    @torch.no_grad()
    def make_batch():
        shape = (batch, 1, 1, 1)
        clean = natural_frames(gen, batch, patch, patch)
        if pool is not None:
            photo = pool[_randint(gen, 0, pool.shape[0], (batch,))]
            clean = torch.where(_bernoulli(gen, photo_fraction, shape), photo, clean)
        ends = perceptual_endpoints(clean, _normal(gen, clean.shape),
                                    _uniform(gen, (batch,), 16.0, 38.0),
                                    _bernoulli(gen, 0.7, (batch,)))
        end = ends[_randint(gen, 0, ends.shape[0], (batch,)), torch.arange(batch, device=dev)]
        # t2's step shares t1's draw, as the JAX package's one key gives
        u = torch.rand(shape, generator=gen, device=dev)
        t1 = 0.05 + 0.5 * u
        t2 = t1 + (0.25 + 0.2 * u)
        return clean, (1 - t1) * clean + t1 * end, (1 - t2) * clean + t2 * end

    trainer = Trainer(perceptual_loss(model), model, mesh=_mesh(dev.type), learning_rate=lr,
                      ckpt_dir=ckpt_dir, device=dev)
    _loop(trainer, make_batch, steps, "perceptual", log_every, lambda step, steps_: None, dev)
    trainer.sync_model()
    trainer.save("perceptual")
    return trainer


def saliency_loss(model: nn.Module) -> Callable:
    """``loss_fn(params, (clip, target))``: the net's mean square error
    against the teacher's saliency map."""

    def loss_fn(p, data):
        clip, target = data
        return torch.mean((functional_call(model, p, (clip,)) - target) ** 2)

    return loss_fn


def train_saliency(steps: int, ckpt_dir: Optional[str], lr: float = 1e-3, frames: int = 8,
                   patch: int = 64, log_every: int = 50, photo_fraction: float = 0.3,
                   device: "str | torch.device" = "cuda"):
    """Distill the motion-contrast heuristic (the bootstrap teacher) into
    the SaliencyNet, on short clips with coherent motion (a
    ``photo_fraction`` chance of a pan over a real photograph, else a rolled
    synthetic frame). Constant learning rate, no mesh."""
    from elvis_tpu_torch.models import SaliencyNet
    from elvis_tpu_torch.scoring import motion_contrast_saliency
    from elvis_tpu_torch.train.data import (
        _bernoulli, photo_patch_pool, photo_video_batch, synthetic_video_batch)
    from elvis_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    model = SaliencyNet().to(dev)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    max_pan = 3
    pool = (torch.as_tensor(photo_patch_pool(patch + 2 * max_pan * frames, True, 256, 4),
                            device=dev) if photo_fraction > 0 else None)

    @torch.no_grad()
    def make_batch():
        if pool is not None and bool(_bernoulli(gen, photo_fraction, ())):
            clip = photo_video_batch(gen, pool, frames, patch, patch, max_pan)
        else:
            clip = synthetic_video_batch(gen, frames, patch, patch)
        return clip, motion_contrast_saliency(clip)

    trainer = Trainer(saliency_loss(model), model, mesh=_one_device(dev), learning_rate=lr,
                      ckpt_dir=ckpt_dir, device=dev)
    _loop(trainer, make_batch, steps, "saliency", log_every, lambda step, steps_: None, dev)
    trainer.sync_model()
    trainer.save("saliency")
    return trainer


_TRAINERS = {
    "srnet": train_srnet,
    "srnet_compact": train_srnet_compact,
    "srnet_student": train_srnet_student,
    "srnet_4k": train_srnet_4k,
    "deblur": train_deblur,
    "diffusion": train_diffusion,
    "inpaint": train_inpaint,
    "perceptual": train_perceptual,
    "saliency": train_saliency,
}


def main(argv=None, device: "str | torch.device" = "cuda") -> int:
    """The JAX package's flags, plus ``--photo-fraction`` (the photo pool
    needs PIL; 0 trains on the procedural sources alone). Runs on
    ``device``: the card unless a caller asks for the CPU."""
    p = argparse.ArgumentParser(description="train elvis-tpu restorers (PyTorch/CUDA port)")
    p.add_argument("model", choices=sorted(_TRAINERS))
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--ckpt-dir", type=str, default="checkpoints")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--val-every", type=int, default=0,
                   help="EMA + best-checkpoint selection on the held-out photo strip every "
                        "N steps (srnet*/deblur/diffusion)")
    p.add_argument("--features", type=int, default=None,
                   help="student conv width (srnet_student/srnet_4k)")
    p.add_argument("--num-convs", type=int, default=None,
                   help="student conv depth (srnet_student/srnet_4k)")
    p.add_argument("--distill-weight", type=float, default=None,
                   help="ensemble-distillation loss weight (srnet_student; 0 = no teachers)")
    p.add_argument("--teacher-dihedral", action="store_true",
                   help="average teacher forwards over the 8 dihedral transforms "
                        "(srnet_student)")
    p.add_argument("--extra-teacher", action="append", default=[], dest="extra_teachers",
                   metavar="WEIGHTS_NPZ",
                   help="an earlier student's weights file to add to the teacher average "
                        "(repeatable)")
    p.add_argument("--sensor-fraction", type=float, default=None,
                   help="fraction of samples given noisy ground truth (data.sensor_augment)")
    p.add_argument("--jpeg-gt-fraction", type=float, default=None,
                   help="fraction of samples whose ground truth is mildly JPEG-quantized")
    p.add_argument("--photos", type=str, default=None,
                   help="comma-separated photo corpus source names")
    p.add_argument("--photo-fraction", type=float, default=None,
                   help="fraction of photo patches in a batch (needs PIL; 0 = procedural "
                        "sources only)")
    args = p.parse_args(argv)
    trainer = _TRAINERS[args.model]
    sig = inspect.signature(trainer).parameters
    kw = dict(lr=args.lr)
    if "val_every" in sig:
        kw["val_every"] = args.val_every
    for extra in ("features", "num_convs", "distill_weight", "sensor_fraction",
                  "jpeg_gt_fraction", "photo_fraction"):
        if getattr(args, extra) is not None and extra in sig:
            kw[extra] = getattr(args, extra)
    if args.photos is not None and "photos" in sig:
        kw["photos"] = tuple(s for s in args.photos.split(",") if s)
    if args.teacher_dihedral and "teacher_dihedral" in sig:
        kw["teacher_dihedral"] = True
    if args.extra_teachers and "extra_teachers" in sig:
        kw["extra_teachers"] = tuple(args.extra_teachers)
    if "device" in sig:
        kw["device"] = device
    trainer(args.steps, args.ckpt_dir, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
