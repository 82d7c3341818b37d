"""PRESLEY experiment sweep: the shrink / ROI / degradation ablation (port
of ``elvis_tpu.presley``).

The same config surface (``PresleyConfig``: the JAX package's field names
and defaults; argparse over its fields) and the same sweep, each row timed
through ``utils.measure_performance`` into
``<output_dir>/performance_metrics.json``:

  * ``baseline``: the clip through the NVC codec at the quality preset's QP;
  * per shrink method: the greedy shrink (``degrade.shrink``), encode,
    decode, stretch, then the three inpaint backends (``telea`` = the PDE
    fill, ``propainter`` = temporal propagation, ``e2fgvi`` = the net);
  * ``roi_nvc``: the NVC codec's per-block delta-QP from importance;
  * the downsample ladder (Lanczos, Lanczos + temporal blend, the naive and
    adaptive neural SR rows), the scale-factor variant, and the blur ladder
    (unsharp, the deblur net, the diffusion restorer, the naive diffusion).

Every stage runs on ``device`` (default the card; raises without one).
Nothing runs at import time. Run: ``python -m elvis_tpu_torch.presley``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["PresleyConfig", "parse_and_update_config", "run_presley", "main"]


@dataclass
class PresleyConfig:
    reference_video: str = "synthetic://moving?frames=20"
    width: int = 1280
    height: int = 720
    frame_stride: int = 1
    max_frames: int = 20
    framerate: Optional[float] = None
    quality: str = "medium"
    qp_range: Optional[int] = None
    block_size: int = 16
    alpha: float = 0.5
    beta: float = 0.5
    shrink_amount: float = 0.25
    propainter_ref_stride: int = 10
    propainter_neighbor_length: int = 4
    propainter_subvideo_length: int = 20
    propainter_mask_dilation: int = 4
    propainter_raft_iter: int = 20
    propainter_fp16: bool = True
    e2fgvi_ref_stride: int = 10
    e2fgvi_neighbor_stride: int = 5
    e2fgvi_num_ref: int = 4
    e2fgvi_mask_dilation: int = 4
    downsample_max_scale: int = 4
    blur_max_rounds: int = 4
    context_halo: int = 8
    temporal_blend: float = 0.1
    metrics_to_exclude: List[str] = field(default_factory=lambda: ["fvmd", "lpips"])
    neural_tile_size: int = 128
    realesrgan_denoise_strength: float = 0.3
    realesrgan_pre_pad: int = 0
    realesrgan_fp32: bool = False
    instantir_cfg: float = 2.0
    instantir_creative_start: float = 1.0
    instantir_preview_start: float = 0.0
    instantir_seed: int = 42
    instantir_steps: int = 10
    uav_noise_level: int = 50
    uav_guidance_scale: float = 2.0
    uav_inference_steps: int = 10
    save_intermediate: bool = True
    # framework extensions
    output_dir: str = "presley_results"
    shrink_methods: List[str] = field(default_factory=lambda: ["row_only", "row_col"])


def parse_and_update_config(config_obj: PresleyConfig, argv=None) -> PresleyConfig:
    """Argparse over the dataclass fields: a bool flag toggles its default,
    a list takes JSON (``'["a","b"]'``) or a comma list."""
    parser = argparse.ArgumentParser(description="PRESLEY ablation test (elvis-tpu)")
    for f in dataclasses.fields(PresleyConfig):
        default_val = getattr(config_obj, f.name)
        if isinstance(default_val, bool):
            parser.add_argument(
                f"--{f.name}",
                action="store_false" if default_val else "store_true",
                help=f"Toggle {f.name} (default: {default_val})",
            )
        elif isinstance(default_val, list):
            parser.add_argument(f"--{f.name}", type=str, default=None)
        else:
            ftype = type(default_val) if default_val is not None else str
            parser.add_argument(f"--{f.name}", type=ftype, default=default_val)
    args = parser.parse_args(argv)
    for f in dataclasses.fields(PresleyConfig):
        v = getattr(args, f.name, None)
        if v is None:
            continue
        if isinstance(getattr(config_obj, f.name), list) and isinstance(v, str):
            v = json.loads(v) if v.startswith("[") else v.split(",")
        setattr(config_obj, f.name, v)
    return config_obj


def run_presley(config: PresleyConfig, device: "str | torch.device" = "cuda") -> Dict:
    """Execute the ablation sweep on ``device``; returns the
    performance_metrics dict (also written as JSON)."""
    from elvis_tpu_torch.codec import QUALITY_PRESETS, NvcCodec
    from elvis_tpu_torch.core.blocks import blockwise_reduce
    from elvis_tpu_torch.degrade.adaptive import (
        adaptive_blur,
        adaptive_downsample,
        adaptive_downsample_scale,
    )
    from elvis_tpu_torch.degrade.shrink import shrink_video, stretch_video
    from elvis_tpu_torch.device import resolve_device
    from elvis_tpu_torch.pipeline.config import ElvisConfig
    from elvis_tpu_torch.pipeline.io import load_clip, save_frames_png
    from elvis_tpu_torch.restore import (
        resolve_deblur_backend,
        resolve_inpaint_backend,
        resolve_sr_backend,
        restore_blur_unsharp,
        restore_downsample_lanczos,
        restore_downsample_scale_lanczos,
        temporal_blend,
    )
    from elvis_tpu_torch.scoring import (
        get_saliency_fn,
        importance_scores,
        spatial_temporal_complexity,
    )
    from elvis_tpu_torch.utils import measure_performance

    dev = resolve_device(device)
    os.makedirs(config.output_dir, exist_ok=True)
    # the backend knobs reach the same resolvers run_elvis uses
    econf = ElvisConfig(
        propainter_neighbor_length=config.propainter_neighbor_length,
        propainter_subvideo_length=config.propainter_subvideo_length,
        propainter_ref_stride=config.propainter_ref_stride,
        propainter_mask_dilation=config.propainter_mask_dilation,
        e2fgvi_neighbor_stride=config.e2fgvi_neighbor_stride,
        e2fgvi_ref_stride=config.e2fgvi_ref_stride,
        e2fgvi_num_ref=config.e2fgvi_num_ref,
        e2fgvi_mask_dilation=config.e2fgvi_mask_dilation,
        realesrgan_fp32=config.realesrgan_fp32,
        realesrgan_tile=config.neural_tile_size,
        instantir_seed=config.instantir_seed,
        gaussian_max_rounds=config.blur_max_rounds,
    )
    econf.instantir_steps = config.instantir_steps  # PRESLEY's own knob
    preset = QUALITY_PRESETS[config.quality]
    qp = preset["nvc_qp"]
    qp_range = config.qp_range if config.qp_range is not None else preset["qp_range"]
    b = config.block_size

    frames_np, fps = load_clip(config.reference_video, config.width, config.height, None,
                               device=dev)
    frames_np = frames_np[:: config.frame_stride][: config.max_frames]
    fps = config.framerate or fps
    frames = torch.as_tensor(np.ascontiguousarray(frames_np), device=dev)
    n = frames_np.shape[0]
    duration = n / fps

    # importance scores
    comp = spatial_temporal_complexity(frames.float(), b)
    sal = get_saliency_fn("motion_contrast")(frames.float())
    fg_weight = blockwise_reduce((sal >= 0.5).float(), b, torch.mean)
    importance = importance_scores(comp.SC, comp.TC, (fg_weight > 0.1).float(),
                                   alpha=config.alpha, beta=config.beta)
    fg_masks = sal >= 0.5

    codec = NvcCodec(dev)
    results: Dict = {"config": dataclasses.asdict(config), "methods": {}}
    mx = dict(exclude=config.metrics_to_exclude)

    def measure(fn, label):
        return measure_performance(fn, frames, label=label, reference_frames=frames,
                                   fg_masks=fg_masks, **mx)

    def record(name, rec, stream_bytes=None):
        entry = {k: v for k, v in rec.items() if k != "output"}
        if stream_bytes is not None:
            entry["size_bytes"] = len(stream_bytes)
            entry["bitrate_kbps"] = len(stream_bytes) * 8 / duration / 1000
        results["methods"][name] = entry
        out = rec.get("output")
        if config.save_intermediate and out is not None:
            # per-method restored frames, as PNG
            arr = torch.clamp(torch.round(torch.as_tensor(out).float()), 0, 255).to(torch.uint8)
            save_frames_png(arr, os.path.join(config.output_dir, name))
        return out

    # --- baseline encode ------------------------------------------------------
    stream = codec.encode(frames, qp=qp, framerate=fps)
    decoded, _ = codec.decode(stream)
    record("baseline", measure(lambda f: decoded, "baseline"), stream)

    # --- shrink methods + inpainting -------------------------------------------
    imp_np = importance.cpu().numpy()
    for method in config.shrink_methods:
        shrunk, plans = shrink_video(frames, imp_np, b, config.shrink_amount, method)
        s_stream = codec.encode(shrunk, qp=qp, framerate=fps)
        s_dec, _ = codec.decode(s_stream)
        stretched = stretch_video(s_dec, plans, b)
        removal_mask = torch.as_tensor(np.stack([p.removal_mask for p in plans]), device=dev)
        for inp_name, backend in (("telea", "diffusion"), ("propainter", "temporal"),
                                  ("e2fgvi", "neural")):
            inp_fn, _prov = resolve_inpaint_backend(backend, econf, device=dev)
            label = f"shrink_{method}_{inp_name}"
            record(label, measure(lambda f, fn=inp_fn: fn(stretched, removal_mask, b), label),
                   s_stream)

    # --- ROI encode ---------------------------------------------------------------
    dqp_f = (1.0 - imp_np) * 2 * qp_range - qp_range
    dqp_f = dqp_f - dqp_f.mean(axis=(1, 2), keepdims=True)
    dqp = np.clip(np.round(dqp_f), -14, 14).astype(np.int8)
    roi_stream = codec.encode(frames, qp=qp, framerate=fps, roi_delta_qp=dqp)
    roi_dec, _ = codec.decode(roi_stream)
    record("roi_nvc", measure(lambda f: roi_dec, "roi_nvc"), roi_stream)

    # --- degradation + restoration ladder ---------------------------------------
    removability = 1.0 - importance  # degrade the unimportant
    down, down_levels = adaptive_downsample(frames, removability, b)
    down_stream = codec.encode(down, qp=qp, framerate=fps)
    down_dec, _ = codec.decode(down_stream)
    sr_naive, _ = resolve_sr_backend("naive_sr", econf, device=dev)
    sr_adapt, _ = resolve_sr_backend("realesrgan", econf, device=dev)
    for name, fn in (
        ("lanczos", lambda f: restore_downsample_lanczos(down_dec, down_levels, b)),
        ("lanczos_tb", lambda f: temporal_blend(
            restore_downsample_lanczos(down_dec, down_levels, b), config.temporal_blend)),
        # the naive (map-blind) and adaptive neural SR rows
        ("realesrgan_naive", lambda f: sr_naive(down_dec.float(), down_levels, b)),
        ("realesrgan_adaptive", lambda f: sr_adapt(down_dec.float(), down_levels, b)),
    ):
        record(f"downsample_{name}", measure(fn, f"downsample_{name}"), down_stream)

    # scale-factor degradation at downsample_max_scale
    down_s, scale_map = adaptive_downsample_scale(frames, importance, b,
                                                  config.downsample_max_scale)
    ds_stream = codec.encode(down_s, qp=qp, framerate=fps)
    ds_dec, _ = codec.decode(ds_stream)
    record("downsample_scale_lanczos",
           measure(lambda f: restore_downsample_scale_lanczos(
               ds_dec, scale_map, b, config.downsample_max_scale),
               "downsample_scale_lanczos"),
           ds_stream)

    blur, blur_levels = adaptive_blur(frames, removability, b, config.blur_max_rounds)
    blur_stream = codec.encode(blur, qp=qp, framerate=fps)
    blur_dec, _ = codec.decode(blur_stream)
    deblur_rows = [("blur_unsharp", lambda f: restore_blur_unsharp(
        blur_dec, blur_levels, b, config.blur_max_rounds))]
    # the InstantIR slot: the trained deblur net, the shipped diffusion
    # restorer (instantir_seed / instantir_steps) and the naive diffusion
    for row, backend in (("blur_deblur_net", "deblur_net"),
                         ("blur_instantir_adaptive", "diffusion"),
                         ("blur_instantir_naive", "naive_diffusion")):
        fn, _prov = resolve_deblur_backend(backend, econf, device=dev)
        deblur_rows.append((row, lambda f, fn=fn: fn(blur_dec.float(), blur_levels, b)))
    for row, fn in deblur_rows:
        record(row, measure(fn, row), blur_stream)

    out_path = os.path.join(config.output_dir, "performance_metrics.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=4, default=float)
    print(f"performance metrics saved to {out_path}")
    return results


def main(argv=None) -> int:
    config = parse_and_update_config(PresleyConfig(), argv)
    run_presley(config)
    return 0


if __name__ == "__main__":
    main()
