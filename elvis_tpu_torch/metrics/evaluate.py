"""Evaluation fan-out (port of ``elvis_tpu.metrics.evaluate``): every
approach's decoded frames against the reference.

Per approach a dict with 'foreground'/'background' sections (psnr/ssim/
mse/lpips mean+std, fvmd), plus 'bitrate_mbps'. Foreground metrics run on
the masks' union-bbox crop against the per-frame FG mask; background
metrics run full-frame against the inverted mask; LPIPS on frames zeroed
outside the region; VMAF on masked crop videos when the binary exists.
Frames and masks are tensors on one device; each metric chunk and each
FVMD span runs there.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from elvis_tpu_torch.metrics.fvmd import fvmd_from_features, region_motion_features
from elvis_tpu_torch.metrics.perceptual import ensure_loaded, lpips_distance
from elvis_tpu_torch.metrics.pixel import mask_union_bbox, masked_mse, masked_psnr, masked_ssim
from elvis_tpu_torch.metrics.vmaf import compute_vmaf, vmaf_available

__all__ = ["evaluate_approach", "analyze_encoding_performance"]

# Frames per metric chunk: ~8M px (4 frames at 1080p) bounds the SSIM/LPIPS
# working set; per-frame metrics are frame-independent, so chunking is exact.
_EVAL_CHUNK_PIXELS = 1 << 23


def _stats(vals: np.ndarray) -> Dict[str, float]:
    vals = np.asarray(vals, dtype=np.float64)
    return {"mean": float(vals.mean()) if vals.size else 0.0,
            "std": float(vals.std()) if vals.size else 0.0}


def _chunk_metrics(ref_c, dec_c, fg_c, bbox, bg_bbox):
    """All eight per-frame metric vectors for one frame chunk. FG: ROI crop
    (bbox) + mask; BG: full frame + inverted mask; LPIPS on frames zeroed
    outside the region."""
    x, y, w, h = bbox
    ref_c = ref_c.float()
    dec_c = dec_c.float()
    bg_c = ~fg_c
    ref_roi = ref_c[:, y: y + h, x: x + w]
    dec_roi = dec_c[:, y: y + h, x: x + w]
    fg_roi = fg_c[:, y: y + h, x: x + w]
    fgf = fg_roi[..., None].float()
    fg_pix = fg_c[..., None].float()
    return (
        masked_psnr(ref_roi, dec_roi, fg_roi),
        masked_mse(ref_roi, dec_roi, fg_roi),
        masked_ssim(ref_c, dec_c, fg_c, bbox=bbox),
        masked_psnr(ref_c, dec_c, bg_c),
        masked_mse(ref_c, dec_c, bg_c),
        masked_ssim(ref_c, dec_c, bg_c, bbox=bg_bbox),
        lpips_distance(ref_roi * fgf, dec_roi * fgf),
        lpips_distance(ref_c * (1 - fg_pix), dec_c * (1 - fg_pix)),
    )


def evaluate_approach(
    reference_frames: torch.Tensor,
    decoded_frames: torch.Tensor,
    fg_masks: torch.Tensor,
    bitrate_bps: float,
    *,
    metric_stride: int = 1,
    enable_fvmd: bool = True,
    fvmd_stride: int = 1,
    fvmd_early_stop_delta: float = 0.002,
    fvmd_early_stop_window: int = 50,
    fvmd_max_frames: Optional[int] = None,
    enable_vmaf: bool = True,
    vmaf_stride: int = 1,
    framerate: float = 30.0,
    ref_feat_cache: Optional[dict] = None,
) -> Dict:
    """One approach -> the reference's per-video result dict.

    ``ref_feat_cache``: a dict reused across approaches; the reference
    clip's FVMD features (FG+BG) are stored per (frame_count, stride,
    max_frames) key and extracted once."""
    ref = torch.as_tensor(reference_frames)
    dev = ref.device
    n = min(ref.shape[0], decoded_frames.shape[0])
    ref = ref[:n]
    dec = torch.as_tensor(decoded_frames, device=dev)[:n]
    fg = torch.as_tensor(fg_masks, device=dev)[:n].bool()

    idx = torch.arange(0, n, metric_stride, device=dev)
    bbox = mask_union_bbox(fg)
    # the BG bbox: union of the STRIDED inverted masks
    bg_bbox = mask_union_bbox(~fg[idx])
    ensure_loaded(dev)

    frame_px = int(ref.shape[1]) * int(ref.shape[2])
    chunk = max(1, _EVAL_CHUNK_PIXELS // frame_px)
    cols = tuple([] for _ in range(8))
    for s in range(0, len(idx), chunk):
        sel = idx[s: s + chunk]
        outs = _chunk_metrics(ref[sel], dec[sel], fg[sel], bbox, bg_bbox)
        for c, o in zip(cols, outs):
            c.append(o.detach().cpu().numpy())
    (fg_psnr, fg_mse, fg_ssim, bg_psnr, bg_mse, bg_ssim,
     fg_lpips, bg_lpips) = (np.concatenate(c) for c in cols)

    result = {
        "foreground": {
            "psnr_mean": _stats(fg_psnr)["mean"], "psnr_std": _stats(fg_psnr)["std"],
            "ssim_mean": _stats(fg_ssim)["mean"], "ssim_std": _stats(fg_ssim)["std"],
            "mse_mean": _stats(fg_mse)["mean"], "mse_std": _stats(fg_mse)["std"],
            "lpips_mean": _stats(fg_lpips)["mean"], "lpips_std": _stats(fg_lpips)["std"],
            "fvmd": float("nan"), "fvmd_std": float("nan"),
        },
        "background": {
            "psnr_mean": _stats(bg_psnr)["mean"], "psnr_std": _stats(bg_psnr)["std"],
            "ssim_mean": _stats(bg_ssim)["mean"], "ssim_std": _stats(bg_ssim)["std"],
            "mse_mean": _stats(bg_mse)["mean"], "mse_std": _stats(bg_mse)["std"],
            "lpips_mean": _stats(bg_lpips)["mean"], "lpips_std": _stats(bg_lpips)["std"],
            "fvmd": float("nan"), "fvmd_std": float("nan"),
        },
        "bitrate_mbps": bitrate_bps / 1_000_000,
    }

    if enable_fvmd and n >= 4:
        # incremental early stop + sliding-window std; FG and BG features
        # from one motion field per span, the reference clip's shared
        # across approaches through ref_feat_cache
        feat_kw = dict(stride=fvmd_stride, max_frames=fvmd_max_frames)
        es_kw = dict(early_stop_delta=fvmd_early_stop_delta, window=fvmd_early_stop_window)
        key = (n, fvmd_stride, fvmd_max_frames)
        if ref_feat_cache is not None and key in ref_feat_cache:
            ref_fg_feats, ref_bg_feats = ref_feat_cache[key]
        else:
            ref_fg_feats, ref_bg_feats = region_motion_features(ref, fg, **feat_kw)
            if ref_feat_cache is not None:
                ref_feat_cache[key] = (ref_fg_feats, ref_bg_feats)
        dec_fg_feats, dec_bg_feats = region_motion_features(dec, fg, **feat_kw)
        fg_v, fg_std = fvmd_from_features(ref_fg_feats, dec_fg_feats, **es_kw)
        result["foreground"]["fvmd"] = fg_v
        result["foreground"]["fvmd_std"] = fg_std
        bg_v, bg_std = fvmd_from_features(ref_bg_feats, dec_bg_feats, **es_kw)
        result["background"]["fvmd"] = bg_v
        result["background"]["fvmd_std"] = bg_std

    if enable_vmaf and vmaf_available():
        # per-region masked-crop VMAF: foreground on the mask-zeroed bbox
        # crop, background on the FG-zeroed frames, plus the full frame
        x, y, w, h = bbox
        vs = torch.arange(0, n, vmaf_stride, device=dev)
        fgm = fg[vs][..., None].float()
        ref_v = ref[vs].float()
        dec_v = dec[vs].float()
        crop = (slice(None), slice(y, y + h), slice(x, x + w))
        fg_crop_r = (ref_v[crop] * fgm[crop]).cpu().numpy()
        fg_crop_d = (dec_v[crop] * fgm[crop]).cpu().numpy()
        result["foreground"]["vmaf"] = compute_vmaf(fg_crop_r, fg_crop_d, framerate)["mean"]
        result["background"]["vmaf"] = compute_vmaf(
            (ref_v * (1 - fgm)).cpu().numpy(), (dec_v * (1 - fgm)).cpu().numpy(), framerate
        )["mean"]
        result["vmaf"] = compute_vmaf(ref_v.cpu().numpy(), dec_v.cpu().numpy(), framerate)
    return result


def analyze_encoding_performance(
    reference_frames: torch.Tensor,
    decoded_videos: Dict[str, torch.Tensor],
    fg_masks: torch.Tensor,
    video_bitrates: Dict[str, float],
    *,
    framerate: float = 30.0,
    metric_stride: int = 1,
    enable_fvmd: bool = True,
    fvmd_stride: int = 1,
    fvmd_early_stop_delta: float = 0.002,
    fvmd_early_stop_window: int = 50,
    fvmd_max_frames: Optional[int] = None,
    enable_vmaf: bool = True,
    vmaf_stride: int = 1,
    analysis_sample_frames: Optional[int] = None,
    verbose: bool = False,
    consume: bool = False,
) -> Dict:
    """All approaches -> {label: result dict} (the analysis_results.json
    body). ``analysis_sample_frames`` caps the frames entering the
    analysis; ``verbose`` prints one line per finished approach;
    ``consume=True`` pops each decoded clip out of ``decoded_videos`` as it
    finishes (evaluation is each clip's last use)."""
    if analysis_sample_frames:
        reference_frames = reference_frames[:analysis_sample_frames]
    out: Dict[str, Dict] = {}
    ref_feat_cache: Dict = {}
    for label in list(decoded_videos.keys()):
        frames = decoded_videos.pop(label) if consume else decoded_videos[label]
        t0 = time.time()
        out[label] = evaluate_approach(
            reference_frames,
            frames if not analysis_sample_frames else frames[:analysis_sample_frames],
            fg_masks,
            video_bitrates.get(label, 0.0),
            metric_stride=metric_stride,
            enable_fvmd=enable_fvmd,
            fvmd_stride=fvmd_stride,
            fvmd_early_stop_delta=fvmd_early_stop_delta,
            fvmd_early_stop_window=fvmd_early_stop_window,
            fvmd_max_frames=fvmd_max_frames,
            enable_vmaf=enable_vmaf,
            vmaf_stride=vmaf_stride,
            framerate=framerate,
            ref_feat_cache=ref_feat_cache,
        )
        out[label]["evaluation_seconds"] = time.time() - t0
        if verbose:
            print(f"[elvis_tpu_torch]   evaluated {label}: "
                  f"{out[label]['evaluation_seconds']:.1f}s", flush=True)
    return out
