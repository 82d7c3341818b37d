"""Rate-distortion curve sweep: quality against bitrate per approach (port
of ``elvis_tpu.search.rd_curve``).

The built-in NVC codec's QP ladder for each approach: the degradation maps
are computed once (scoring, adaptive downsample and blur through the
transform kernel on the card), and only the encode and restore ends move
along the ladder. Each degraded approach is charged the compressed
strength-map sidecar it ships. The output is the curve data (JSON) and,
where matplotlib is installed, a figure (``plot_curves``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from elvis_tpu_torch.device import resolve_device

__all__ = ["rd_sweep", "plot_curves", "main"]


@torch.no_grad()
def rd_sweep(source: str = "synthetic://moving?frames=12", width: int = 256, height: int = 192,
             block_size: int = 8, qps: tuple = (20, 26, 32, 38, 44),
             out_json: Optional[str] = None,
             device: "str | torch.device" = "cuda") -> Dict[str, List[Dict]]:
    """{approach: [{qp, kbps, psnr, ssim}, ...]} for the baseline, the ROI
    (importance delta-QP) encode, the adaptive downsample restored by the
    progressive loop and by per-block Lanczos, and the adaptive blur
    restored by unsharp; one point per QP. Runs on ``device``."""
    from elvis_tpu_torch.codec import NvcCodec
    from elvis_tpu_torch.codec.sidecar import encode_strength_maps
    from elvis_tpu_torch.core.blocks import blockwise_reduce
    from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline.io import load_clip
    from elvis_tpu_torch.restore import restore_blur_unsharp, restore_downsample_lanczos
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.scoring import (
        get_saliency_fn, importance_scores, removability_scores, saliency_to_block_mask,
        spatial_temporal_complexity)

    dev = resolve_device(device)
    frames_np, fps = load_clip(source, width, height, device=dev)
    duration = frames_np.shape[0] / fps
    x = torch.as_tensor(frames_np, device=dev).float()

    comp = spatial_temporal_complexity(x, block_size)
    sal = get_saliency_fn("motion_contrast")(x)
    fg_block = saliency_to_block_mask(sal, block_size)
    scores = removability_scores(comp.SC, comp.TC, fg_block)
    fg_frac = blockwise_reduce((sal >= 0.5).float(), block_size, torch.mean)
    imp = importance_scores(comp.SC, comp.TC, (fg_frac > 0.1).float())

    down_frames, down_levels = adaptive_downsample(x, scores, block_size)
    blur_frames, blur_levels = adaptive_blur(x, scores, block_size)
    # each degraded approach pays the compressed sidecar the pipeline ships
    down_sidecar_bytes = len(encode_strength_maps(down_levels.cpu().numpy().astype(np.uint8)))
    blur_sidecar_bytes = len(encode_strength_maps(blur_levels.cpu().numpy().astype(np.uint8)))
    dqp_f = (1.0 - imp.cpu().numpy().astype(np.float64)) * 30.0 - 15.0
    dqp_f -= dqp_f.mean(axis=(1, 2), keepdims=True)
    dqp = np.clip(np.round(dqp_f), -14, 14).astype(np.int8)
    down_u8 = down_frames.cpu().numpy().astype(np.uint8)
    blur_u8 = blur_frames.cpu().numpy().astype(np.uint8)

    codec = NvcCodec(device=dev)

    def quality(dec) -> Dict[str, float]:
        d = torch.as_tensor(dec, device=dev).float()
        return {"psnr": float(masked_psnr(x, d).mean()), "ssim": float(masked_ssim(x, d).mean())}

    curves: Dict[str, List[Dict]] = {}

    def add(label, qp, stream, dec, extra_bytes=0):
        point = {"qp": qp, "kbps": (len(stream) + extra_bytes) * 8 / duration / 1000}
        point.update(quality(dec))
        curves.setdefault(label, []).append(point)

    max_level = int(down_levels.max())
    for qp in qps:
        s = codec.encode(frames_np, qp=qp, framerate=fps)
        add("Baseline", qp, s, codec.decode(s)[0])

        s_roi = codec.encode(frames_np, qp=qp, framerate=fps, roi_delta_qp=dqp)
        add("PRESLEY QP", qp, s_roi, codec.decode(s_roi)[0])

        s_dn = codec.encode(down_u8, qp=qp, framerate=fps)
        dn_dec = codec.decode(s_dn)[0]
        add("PRESLEY RealESRGAN", qp, s_dn,
            progressive_restore(dn_dec, down_levels, block_size, max_level=max_level),
            extra_bytes=down_sidecar_bytes)
        add("PRESLEY Lanczos", qp, s_dn,
            restore_downsample_lanczos(dn_dec, down_levels, block_size),
            extra_bytes=down_sidecar_bytes)

        s_bl = codec.encode(blur_u8, qp=qp, framerate=fps)
        add("PRESLEY Unsharp", qp, s_bl,
            restore_blur_unsharp(codec.decode(s_bl)[0], blur_levels, block_size),
            extra_bytes=blur_sidecar_bytes)

    if out_json:
        with open(out_json, "w") as f:
            json.dump(curves, f, indent=2)
    return curves


def plot_curves(curves: Dict[str, List[Dict]], out_png: str, metric: str = "psnr"):
    """One line per approach, ``metric`` against kbps (log axis); needs
    matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for label, pts in curves.items():
        pts = sorted(pts, key=lambda p: p["kbps"])
        ax.plot([p["kbps"] for p in pts], [p[metric] for p in pts], marker="o", ms=3,
                label=label)
    ax.set_xlabel("kbps")
    ax.set_ylabel(metric.upper())
    ax.set_xscale("log")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(argv=None, device: "str | torch.device" = "cuda"):
    import argparse

    p = argparse.ArgumentParser(description="RD-curve sweep (PyTorch/CUDA port)")
    p.add_argument("--source", default="synthetic://moving?frames=12")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--qps", type=str, default="20,26,32,38,44")
    p.add_argument("--out-json", default="rd_curves.json")
    p.add_argument("--out-png", default=None)
    args = p.parse_args(argv)
    curves = rd_sweep(args.source, args.width, args.height,
                      qps=tuple(int(q) for q in args.qps.split(",")), out_json=args.out_json,
                      device=device)
    if args.out_png:
        plot_curves(curves, args.out_png)
    for label, pts in curves.items():
        for pt in sorted(pts, key=lambda x: x["kbps"]):
            print(f"{label:22s} qp={pt['qp']:2d} {pt['kbps']:8.1f} kbps "
                  f"PSNR {pt['psnr']:.2f} SSIM {pt['ssim']:.4f}")


if __name__ == "__main__":
    main()
