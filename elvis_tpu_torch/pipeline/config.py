"""ElvisConfig: the pipeline's single config dataclass (port of
``elvis_tpu.pipeline.config``).

Every field of the JAX package's ``ElvisConfig``, with the same names,
defaults and order, so ``to_dict()`` -- which feeds the stage cache's key
and ``parameters.config`` of ``analysis_results.json`` -- is the same dict.
Each field is either LIVE (it parameterizes a mechanism of the port) or
listed in ``ABSORBED_FIELDS`` with the reason it has no counterpart.

The device is not a field: ``run_elvis(config, device=...)`` takes it, so
the config dict stays the JAX package's.

Merge order: dataclass defaults -> --config JSON -> individual CLI flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "ElvisConfig",
    "load_config_from_cli",
    "config_from_dict",
    "ABSORBED_FIELDS",
]

# Fields with no mechanism to drive: the JAX package's nine (its reasons),
# plus ``compilation_cache``, which the port has none for.
ABSORBED_FIELDS = {
    # sized the reference's per-GPU FVMD process pool; FVMD here is batched
    # tensor reductions with no process pool
    "fvmd_processes",
    # RAFT's refinement count; motion guidance is single-shot block matching
    "propainter_raft_iter",
    # fp16 inference of ProPainter; the counterpart slot is gathers and
    # integer compares, with no matmul precision to select
    "propainter_fp16",
    # DNI strength between two paired weight sets; no such pair exists
    "realesrgan_denoise_strength",
    # border pre-pad around CUDA tiling; the height-tile driver uses clamped
    # windows, so borders keep their true padding
    "realesrgan_pre_pad",
    # host worker threads per GPU; stages are single device calls
    "realesrgan_per_device_workers",
    # SDXL guidance and the InstantIR preview/creative boundaries; the
    # diffusion restorer has no text guidance and no such phases
    "instantir_cfg",
    "instantir_creative_start",
    "instantir_preview_start",
    # the persistent XLA executable cache of the JAX package; PyTorch runs
    # eagerly and compiles nothing per stage (the hand-written kernels are
    # built once per source into elvis_tpu_torch/_build/ whatever this says)
    "compilation_cache",
}

@dataclass
class ElvisConfig:
    # --- reference fields, names preserved -------------------------------
    reference_video: str = "davis_test/bear.mp4"
    width: int = 640
    height: int = 360
    block_size: int = 8
    shrink_amount: float = 0.25
    # target bitrate = W*H*fps*0.01*quality_factor unless overridden (bps)
    quality_factor: float = 1.2
    target_bitrate_override: Optional[int] = None
    removability_alpha: float = 0.5
    removability_smoothing_beta: float = 0.5
    encode_preset: str = "medium"
    encode_pix_fmt: str = "yuv420p"
    propainter_resize_ratio: float = 1.0
    propainter_ref_stride: int = 20
    propainter_neighbor_length: int = 4
    propainter_subvideo_length: int = 40
    propainter_mask_dilation: int = 4
    propainter_raft_iter: int = 20
    propainter_fp16: bool = True
    propainter_devices: Optional[List[Union[int, str]]] = None
    propainter_parallel_chunk_length: Optional[int] = None
    propainter_chunk_overlap: Optional[int] = None
    e2fgvi_ref_stride: int = 10
    e2fgvi_neighbor_stride: int = 5
    e2fgvi_num_ref: int = -1
    e2fgvi_mask_dilation: int = 4
    e2fgvi_devices: Optional[List[Union[int, str]]] = None
    e2fgvi_parallel_chunk_length: Optional[int] = None
    e2fgvi_chunk_overlap: Optional[int] = None
    realesrgan_denoise_strength: float = 1.0
    # SR height tiling: tile*tile pixels a call, halo max(32, tile_pad) rows
    realesrgan_tile: int = 0
    realesrgan_tile_pad: int = 10
    realesrgan_pre_pad: int = 0
    realesrgan_fp32: bool = False
    realesrgan_devices: Optional[List[Union[int, str]]] = None
    # frames per invocation of an SR backend (None: by pixel budget)
    realesrgan_parallel_chunk_length: Optional[int] = None
    realesrgan_per_device_workers: int = 1
    instantir_cfg: float = 7.0
    instantir_creative_start: float = 1.0
    instantir_preview_start: float = 0.0
    instantir_seed: Optional[int] = 42
    instantir_devices: Optional[List[Union[int, str]]] = None
    instantir_batch_size: int = 4
    # frames per invocation of a deblur backend (None: by pixel budget)
    instantir_parallel_chunk_length: Optional[int] = None
    # the classical rows (per-block Lanczos, unsharp mask)
    generate_opencv_benchmarks: bool = True
    metric_stride: int = 1
    fvmd_stride: int = 1
    fvmd_max_frames: Optional[int] = None
    fvmd_processes: Optional[int] = None
    fvmd_early_stop_delta: float = 0.002
    fvmd_early_stop_window: int = 50
    vmaf_stride: int = 1
    enable_fvmd: bool = True

    # --- fields the reference read/injected but never declared -----------
    # strength-map sidecar: npz (lossless) or a gray video at about
    # strength_maps_target_bitrate (bps)
    strength_maps_use_npz: bool = True
    experiment_dir: Optional[str] = None
    strength_maps_target_bitrate: int = 50000
    analysis_sample_frames: Optional[int] = None
    minimal_figures: bool = False

    # --- framework extensions --------------------------------------------
    codec: str = "nvc"                 # 'nvc' | 'x265' | 'kvazaar' | 'svtav1'
                                       # (the external ones need their
                                       # binaries or ELVIS_TPU_FAKE_CODECS)
    quality_preset: str = "medium"     # QUALITY_PRESETS tier for kvazaar/svtav1
    compilation_cache: bool = True     # the JAX package's XLA cache (absorbed)
    nvc_b_frames: bool = False         # NVC: bi-predicted odd frames
    nvc_me_radius: int = 4             # NVC: per-frame motion budget in pels
                                       # (>7 engages the hierarchical search)
    nvc_multi_ref: bool = False        # NVC: two-reference P prediction
    nvc_deblock: bool = True           # NVC: in-loop deblocking filter
    nvc_intra_pred: bool = True        # NVC: spatial intra prediction on
                                       # keyframes (DC/vert/gradient)
    saliency_backend: str = "motion_contrast"
    # a removed block is protected from removal for this many following
    # frames (0: the reference's pure top-k)
    shrink_removal_cooldown: int = 1
    # encoder-side motion hint for the inpaint fill, shipped in the
    # removal-mask sidecar and charged to the ELVIS rows
    inpaint_motion_hint: bool = True
    # backend lists drive the restoration rows: the first entry fills the
    # reference's label for that slot, extra entries add extra rows
    inpaint_backends: List[str] = field(
        default_factory=lambda: ["diffusion", "temporal", "neural"]
    )
    # 'realesrgan' = the generic slot: resolves to the measured-best tier
    # whose weights ship (srnet_student > srnet_ensemble > srnet_large >
    # srnet_compact > srnet)
    sr_backends: List[str] = field(default_factory=lambda: ["realesrgan"])
    # 'deblur_net' (trained UNet; unsharp without weights) or 'unsharp'
    deblur_backends: List[str] = field(default_factory=lambda: ["deblur_net"])
    auto_load_checkpoints: bool = True
    max_frames: Optional[int] = None
    framerate_override: Optional[float] = None
    roi_qp_range: int = 15
    temporal_blend: float = 0.0
    # blur branch: rounds = round(score * gaussian_max_rounds)
    gaussian_max_rounds: int = 10
    # paths of port weights files (.npz) that pin the SR / deblur net
    srnet_params_path: Optional[str] = None
    deblur_params_path: Optional[str] = None
    inpaint_params_path: Optional[str] = None
    enable_dct_dampen: bool = False
    # scoring, every encode branch and every restore content-addressed
    # under <experiment_dir>/stage_cache
    stage_cache: bool = True
    enable_vmaf: bool = True
    masks_dir: Optional[str] = None  # external FG masks (DAVIS-style PNG dir)
    profile_dir: Optional[str] = None  # torch.profiler trace output
    data_parallel: bool = True  # shard frames over the devices (one card: no mesh)
    verbose: bool = True  # each stage prints its wall-clock as it lands
    spatial_devices: int = 0      # spatial mesh axis size (0 = frame DP only)
    spatial_tile_threshold: int = 1440  # min height (px) to engage tiling
    spatial_halo: int = 64        # tile halo rows (multiple of block_size)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def config_from_dict(data: Dict[str, Any], strict: bool = False) -> ElvisConfig:
    """Build a config, tolerating unknown keys (they warn instead of
    crashing unless strict)."""
    known = {f.name for f in dataclasses.fields(ElvisConfig)}
    unknown = {k: v for k, v in data.items() if k not in known}
    if unknown and strict:
        raise TypeError(f"unknown config keys: {sorted(unknown)}")
    if unknown:
        print(f"Warning: ignoring unknown config keys: {sorted(unknown)}")
    return ElvisConfig(**{k: v for k, v in data.items() if k in known})


def load_config_from_cli(argv: Optional[List[str]] = None) -> ElvisConfig:
    """defaults -> --config JSON -> individual flags; one flag per field."""
    parser = argparse.ArgumentParser(description="elvis-tpu pipeline (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, default=None, help="JSON config file")
    for f in dataclasses.fields(ElvisConfig):
        name = f"--{f.name}"
        ann = str(f.type)
        if isinstance(f.default, bool) or ann in ("bool", "Optional[bool]"):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None, metavar="BOOL")
        elif isinstance(f.default, int) or ann in ("int", "Optional[int]"):
            parser.add_argument(name, type=int, default=None)
        elif isinstance(f.default, float) or ann in ("float", "Optional[float]"):
            parser.add_argument(name, type=float, default=None)
        else:
            parser.add_argument(name, type=str, default=None)
    args = parser.parse_args(argv)

    data: Dict[str, Any] = {}
    if args.config:
        with open(args.config) as fh:
            data.update(json.load(fh))
    for f in dataclasses.fields(ElvisConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            # parse JSON-ish strings for list/optional fields
            if isinstance(v, str) and (v.startswith("[") or v.startswith("{")):
                v = json.loads(v)
            data[f.name] = v
    return config_from_dict(data)
