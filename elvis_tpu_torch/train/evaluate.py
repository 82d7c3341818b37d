"""Held-out SR and deblur evaluation: does the trained restorer beat the
classical one? (port of ``elvis_tpu.train.evaluate``)

The families are content the training generator never produced:

  * ``photo``: shifted crops of a real photograph (matplotlib's bundled
    ``grace_hopper.jpg``), read through PIL;
  * ``leaves``: dead-leaves content from a held-out seed;
  * ``legacy``: the band-limited synthetic family (where Lanczos is near
    optimal; the neural model must at least not lose there).

Each clip is degraded by the port's adaptive block downsample (or blur),
optionally given codec noise, restored through the progressive loop with
Lanczos and with the neural upsampler (or unsharp and the deblur net), and
scored with the masked PSNR / SSIM of the pipeline.

``photo_image`` returns None on any failure (no PIL, no photo), as the JAX
package's does, and the photo family then drops out of ``holdout_clips``;
``photo_clips_multi`` needs PIL and raises ``ImportError`` naming it.

Draws: the JAX package takes the clips, scores and codec noise from
``PRNGKey(9999)``, ``(9998)``, ``(7)`` and ``(3)``; the port from
``torch.Generator``s seeded with the same numbers (an intended divergence:
the same formulas, other values). The evaluators take the clips, scores and
codec-noise draws as arguments (``clips=``, ``scores=``, ``codec_draws=``),
as the parity tests hand over JAX's.

CLI: ``python -m elvis_tpu_torch.train.evaluate --ckpt path/to/weights.npz``
(the port's ``.npz`` weights: ``models.io.load_srnet`` / ``load_deblur``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from elvis_tpu_torch.device import resolve_device

__all__ = [
    "holdout_clips",
    "photo_image",
    "photo_clips_multi",
    "sr_holdout_eval",
    "sr_photo_eval_multi",
    "deblur_holdout_eval",
    "main",
]

SCORES_SEED, CODEC_SEED, LEAVES_SEED, LEGACY_SEED = 7, 3, 9999, 9998


def photo_image(source: str = "grace_hopper") -> Optional[np.ndarray]:
    """One of the real photographs bundled in installed packages, ``(H, W,
    3)`` float32: matplotlib's ``grace_hopper`` (the default holdout),
    sklearn's ``china`` / ``flower``, pygame's ``camera`` or
    gymnasium_robotics' ``marble_tile``; None on any failure (no PIL, no
    package, no file)."""
    try:
        from PIL import Image

        if source == "grace_hopper":
            import matplotlib

            path = os.path.join(os.path.dirname(matplotlib.__file__),
                                "mpl-data", "sample_data", "grace_hopper.jpg")
        elif source == "camera":
            os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
            import pygame

            path = os.path.join(os.path.dirname(pygame.__file__), "docs", "generated",
                                "_images", "camera_rgb.jpg")
        elif source == "marble_tile":
            import contextlib
            import io

            with contextlib.redirect_stdout(io.StringIO()):
                import gymnasium_robotics  # prints a version notice

            path = os.path.join(os.path.dirname(gymnasium_robotics.__file__), "envs", "assets",
                                "kitchen_franka", "kitchen_assets", "textures",
                                "white_marble_tile.png")
        else:
            import sklearn

            path = os.path.join(os.path.dirname(sklearn.__file__), "datasets", "images",
                                f"{source}.jpg")
        return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    except Exception:
        return None


def _photo_clip(frames: int, size: int) -> Optional[np.ndarray]:
    """Shifted crops of the bundled photo: a small pan 'clip'."""
    img = photo_image("grace_hopper")
    if img is None:
        return None
    h, w = img.shape[:2]
    if h < size + frames * 4 or w < size:
        return None
    return np.stack([img[4 * t: 4 * t + size, :size] for t in range(frames)])


def photo_clips_multi(frames: int = 2, size: int = 192, max_clips: int = 12,
                      source: str = "grace_hopper") -> list:
    """Pan clips tiling the eval photo across crops AND scales (1, 0.75,
    0.5 through PIL's Lanczos): the population behind mean +- std
    reporting. Raises ``ImportError`` without PIL; [] without the photo."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("photo_clips_multi needs PIL (Pillow), which is not installed") \
            from exc

    img = photo_image(source)
    if img is None:
        return []
    clips = []
    for s in (1.0, 0.75, 0.5):
        if s == 1.0:
            a = img
        else:
            im = Image.fromarray(img.astype(np.uint8))
            a = np.asarray(im.resize((int(img.shape[1] * s), int(img.shape[0] * s)),
                                     Image.LANCZOS), np.float32)
        h, w = a.shape[:2]
        need_h = size + 4 * (frames - 1)
        if h < need_h or w < size:
            continue
        ys = np.unique(np.linspace(0, h - need_h, 2 if s < 1.0 else 3).astype(int))
        xs = np.unique(np.linspace(0, w - size, 2 if s < 1.0 else 3).astype(int))
        for y in ys:
            for x in xs:
                clips.append(np.stack([a[y + 4 * t: y + 4 * t + size, x: x + size]
                                       for t in range(frames)]))
    return clips[:max_clips]


def holdout_clips(frames: int = 4, size: int = 256,
                  device: "str | torch.device" = "cuda") -> Dict[str, np.ndarray]:
    """Evaluation families, float32 [0,255] ``(N, size, size, 3)`` host
    arrays; the procedural ones are drawn on ``device`` from generators
    seeded 9999 (leaves) and 9998 (legacy). ``photo`` only where
    ``photo_image`` gives the photo."""
    from elvis_tpu_torch.train.data import dead_leaves, synthetic_frames

    dev = resolve_device(device)
    clips: Dict[str, np.ndarray] = {}
    photo = _photo_clip(frames, size)
    if photo is not None:
        clips["photo"] = photo
    for name, make, seed in (("leaves", dead_leaves, LEAVES_SEED),
                             ("legacy", synthetic_frames, LEGACY_SEED)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        clips[name] = make(gen, frames, size, size).cpu().numpy()
    return clips


def _draw(shape, seed: int, dev: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def _codec_draws(n: int, seed: int, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``codec_noise``'s default draws (QP in [16, 38), applied with
    probability 0.7) from a generator seeded ``seed``."""
    from elvis_tpu_torch.train.data import _bernoulli, _uniform

    gen = torch.Generator(device=dev).manual_seed(seed)
    return _uniform(gen, (n,), 16.0, 38.0), _bernoulli(gen, 0.7, (n,))


def _sr_pair(upsample_fn, clean, degraded, levels, block_size: int, max_level: int):
    """(PSNR Lanczos, PSNR neural, SSIM Lanczos, SSIM neural), clip means."""
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x, progressive_restore

    lz = progressive_restore(degraded, levels, block_size, upsample_fn=lanczos_upsample_2x,
                             max_level=max_level)
    nn_ = progressive_restore(degraded, levels, block_size, upsample_fn=upsample_fn,
                              max_level=max_level)
    return tuple(float(v) for v in (masked_psnr(clean, lz).mean(), masked_psnr(clean, nn_).mean(),
                                    masked_ssim(clean, lz).mean(), masked_ssim(clean, nn_).mean()))


@torch.no_grad()
def sr_holdout_eval(upsample_fn: Callable, *, frames: int = 4, size: int = 256,
                    block_size: int = 8, with_codec_noise: bool = True, max_level: int = 3,
                    device: "str | torch.device" = "cuda",
                    clips: Optional[Dict[str, np.ndarray]] = None,
                    scores: Optional[torch.Tensor] = None,
                    codec_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> Dict[str, Dict[str, float]]:
    """Progressive restore with ``upsample_fn`` against Lanczos on each
    family: {family: {psnr_lanczos, psnr_neural, dpsnr, ssim_lanczos,
    ssim_neural, dssim}}, plus ``<family>_codec`` with codec noise on the
    degraded frames. ``clips`` (default ``holdout_clips``), ``scores``
    ``(frames, size/b, size/b)`` (default: uniform, seed 7) and
    ``codec_draws`` ``(qp, apply)`` (default: seed 3) are shared by the
    families."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.train.data import codec_noise_at

    dev = resolve_device(device)
    by = size // block_size
    if clips is None:
        clips = holdout_clips(frames, size, dev)
    if scores is None:
        scores = _draw((frames, by, by), SCORES_SEED, dev)
    if codec_draws is None:
        codec_draws = _codec_draws(frames, CODEC_SEED, dev)
    results: Dict[str, Dict[str, float]] = {}
    for family, clip in clips.items():
        clean = torch.as_tensor(np.asarray(clip, np.float32), device=dev)
        degraded, levels = adaptive_downsample(clean, scores.to(dev), block_size)
        variants = {family: degraded}
        if with_codec_noise:
            qp, apply = (x.to(dev) for x in codec_draws)
            variants[family + "_codec"] = codec_noise_at(degraded, qp, apply, block_size)
        for name, deg in variants.items():
            p_lz, p_nn, s_lz, s_nn = _sr_pair(upsample_fn, clean, deg, levels, block_size,
                                              max_level)
            results[name] = {
                "psnr_lanczos": round(p_lz, 3),
                "psnr_neural": round(p_nn, 3),
                "dpsnr": round(p_nn - p_lz, 3),
                "ssim_lanczos": round(s_lz, 4),
                "ssim_neural": round(s_nn, 4),
                "dssim": round(s_nn - s_lz, 4),
            }
    return results


@torch.no_grad()
def sr_photo_eval_multi(upsample_fn: Callable, *, frames: int = 2, size: int = 192,
                        block_size: int = 8, max_clips: int = 12,
                        source: str = "grace_hopper", with_codec_noise: bool = True,
                        max_level: int = 3, device: "str | torch.device" = "cuda",
                        clips: Optional[list] = None) -> Dict[str, float]:
    """Photo dPSNR / dSSIM against Lanczos as mean +- std over many crops
    and scales of the held-out photo (``photo_clips_multi``, or ``clips``):
    {n, dpsnr_mean, dpsnr_std, dpsnr_min, dssim_mean, dssim_std,
    psnr_lanczos_mean}; ``{"n": 0}`` without the photo. Clip i's scores
    and codec noise come from generators seeded 7 + i and 3 + i."""
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.train.data import codec_noise_at

    dev = resolve_device(device)
    if clips is None:
        clips = photo_clips_multi(frames, size, max_clips, source)
    if not clips:
        return {"n": 0}
    by = size // block_size
    dpsnrs, dssims, lz_psnrs = [], [], []
    for i, clip in enumerate(clips):
        clean = torch.as_tensor(np.asarray(clip, np.float32), device=dev)
        degraded, levels = adaptive_downsample(
            clean, _draw((clean.shape[0], by, by), SCORES_SEED + i, dev), block_size)
        if with_codec_noise:
            degraded = codec_noise_at(degraded, *_codec_draws(clean.shape[0], CODEC_SEED + i,
                                                              dev), block_size)
        p_lz, p_nn, s_lz, s_nn = _sr_pair(upsample_fn, clean, degraded, levels, block_size,
                                          max_level)
        dpsnrs.append(p_nn - p_lz)
        dssims.append(s_nn - s_lz)
        lz_psnrs.append(p_lz)
    dpsnrs, dssims = np.asarray(dpsnrs), np.asarray(dssims)
    return {
        "n": len(clips),
        "dpsnr_mean": round(float(dpsnrs.mean()), 3),
        "dpsnr_std": round(float(dpsnrs.std()), 3),
        "dpsnr_min": round(float(dpsnrs.min()), 3),
        "dssim_mean": round(float(dssims.mean()), 4),
        "dssim_std": round(float(dssims.std()), 4),
        "psnr_lanczos_mean": round(float(np.mean(lz_psnrs)), 3),
    }


@torch.no_grad()
def deblur_holdout_eval(deblur_fn: Callable, *, frames: int = 4, size: int = 256,
                        block_size: int = 8, max_rounds: int = 10,
                        device: "str | torch.device" = "cuda",
                        clips: Optional[Dict[str, np.ndarray]] = None,
                        scores: Optional[torch.Tensor] = None) -> Dict[str, Dict[str, float]]:
    """A deblur restorer (``deblur_fn(frames, levels, block_size)``) against
    the unsharp baseline and the blurred input on the families of
    :func:`sr_holdout_eval`: {family: {psnr_blurred, psnr_unsharp,
    psnr_neural, dpsnr_vs_blurred, dpsnr_vs_unsharp, ssim_blurred,
    ssim_unsharp, ssim_neural}}."""
    from elvis_tpu_torch.degrade import adaptive_blur
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.restore.unsharp import restore_blur_unsharp

    dev = resolve_device(device)
    by = size // block_size
    if clips is None:
        clips = holdout_clips(frames, size, dev)
    if scores is None:
        scores = _draw((frames, by, by), SCORES_SEED, dev)
    results: Dict[str, Dict[str, float]] = {}
    for family, clip in clips.items():
        clean = torch.as_tensor(np.asarray(clip, np.float32), device=dev)
        degraded, levels = adaptive_blur(clean, scores.to(dev), block_size, max_rounds)
        us = restore_blur_unsharp(degraded, levels, block_size)
        nn_ = deblur_fn(degraded, levels, block_size)
        p_in, p_us, p_nn, s_in, s_us, s_nn = (float(v) for v in (
            masked_psnr(clean, degraded).mean(), masked_psnr(clean, us).mean(),
            masked_psnr(clean, nn_).mean(), masked_ssim(clean, degraded).mean(),
            masked_ssim(clean, us).mean(), masked_ssim(clean, nn_).mean()))
        results[family] = {
            "psnr_blurred": round(p_in, 3),
            "psnr_unsharp": round(p_us, 3),
            "psnr_neural": round(p_nn, 3),
            "dpsnr_vs_blurred": round(p_nn - p_in, 3),
            "dpsnr_vs_unsharp": round(p_nn - p_us, 3),
            "ssim_blurred": round(s_in, 4),
            "ssim_unsharp": round(s_us, 4),
            "ssim_neural": round(s_nn, 4),
        }
    return results


def main(argv=None, device: "str | torch.device" = "cuda") -> int:
    """``--ckpt`` is a port weights file (``.npz``; the suffix may be left
    off), the shipped RRDB ``srnet`` by default; ``--model`` defaults from
    its name. Runs on ``device``: the card unless a caller asks for the
    CPU."""
    from elvis_tpu_torch.models.io import load_deblur, load_srnet, weights_path
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn

    p = argparse.ArgumentParser(description="held-out SR eval vs Lanczos (PyTorch/CUDA port)")
    p.add_argument("--ckpt", default=weights_path("srnet"),
                   help="a port weights file (.npz), e.g. a trainer's <ckpt_dir>/<tag>.npz")
    p.add_argument("--model", choices=["srnet", "srnet_compact", "deblur"], default=None,
                   help="defaults from the ckpt file name")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--json", dest="as_json", action="store_true")
    args = p.parse_args(argv)
    ckpt = args.ckpt if args.ckpt.endswith(".npz") else f"{args.ckpt.rstrip('/')}.npz"
    name = args.model or ("deblur" if "deblur" in ckpt
                          else "srnet_compact" if "compact" in ckpt else "srnet")
    dev = resolve_device(device)
    if photo_image("grace_hopper") is None:
        print("photo family skipped: photo_image found no PIL or no photo", flush=True)
    if name == "deblur":
        model = load_deblur(ckpt, dev)
        res = deblur_holdout_eval(lambda f, lv, b: model(f, lv, b), frames=args.frames,
                                  size=args.size, device=dev)
        if args.as_json:
            print(json.dumps(res, indent=2))
        else:
            for fam, r in res.items():
                print(f"{fam:14s} PSNR blur {r['psnr_blurred']:6.2f} unsharp "
                      f"{r['psnr_unsharp']:6.2f} neural {r['psnr_neural']:6.2f} "
                      f"({r['dpsnr_vs_blurred']:+.2f} vs blur, "
                      f"{r['dpsnr_vs_unsharp']:+.2f} vs unsharp)")
        return 0
    res = sr_holdout_eval(srnet_upsample_fn(load_srnet(ckpt, dev)), frames=args.frames,
                          size=args.size, device=dev)
    if args.as_json:
        print(json.dumps(res, indent=2))
    else:
        for fam, r in res.items():
            print(f"{fam:14s} PSNR {r['psnr_lanczos']:6.2f} -> {r['psnr_neural']:6.2f} "
                  f"({r['dpsnr']:+.3f} dB)   SSIM {r['ssim_lanczos']:.4f} -> "
                  f"{r['ssim_neural']:.4f} ({r['dssim']:+.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
