"""ElvisConfig for the port (own copy of the fields of
``elvis_tpu.pipeline.config.ElvisConfig`` that the ported slice reads).

Field names and defaults are the JAX package's; the remaining fields come
with the pipeline stages that read them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["ElvisConfig"]


@dataclass
class ElvisConfig:
    block_size: int = 8
    # target bitrate = W*H*fps*0.01*quality_factor unless overridden (bps)
    quality_factor: float = 1.2
    target_bitrate_override: Optional[int] = None
    removability_alpha: float = 0.5
    removability_smoothing_beta: float = 0.5
    saliency_backend: str = "motion_contrast"
    # 'realesrgan' = the generic slot: resolves to the measured-best tier
    # whose weights ship (srnet_student > srnet_large > srnet_compact).
    sr_backends: List[str] = field(default_factory=lambda: ["realesrgan"])
    auto_load_checkpoints: bool = True
    # path of a port weights file (.npz) that pins the SR net
    srnet_params_path: Optional[str] = None
    # blur branch: rounds = round(score * gaussian_max_rounds)
    gaussian_max_rounds: int = 10
    # restorers of the blur branch, first = the "PRESLEY InstantIR" row:
    # 'deblur_net' (trained UNet; unsharp without weights) or 'unsharp'
    deblur_backends: List[str] = field(default_factory=lambda: ["deblur_net"])
    # path of a port weights file (.npz) that pins the deblur net
    deblur_params_path: Optional[str] = None
    # the classical rows (per-block Lanczos, unsharp mask)
    generate_opencv_benchmarks: bool = True
    # frames per invocation of a deblur backend (None: by pixel budget)
    instantir_parallel_chunk_length: Optional[int] = None
    # strength-map sidecar: npz (lossless) or a gray video at about
    # strength_maps_target_bitrate (bps)
    strength_maps_use_npz: bool = True
    strength_maps_target_bitrate: int = 50000
    codec: str = "nvc"                 # 'nvc' ('x265' | 'kvazaar' | 'svtav1' not ported yet)
    quality_preset: str = "medium"     # QUALITY_PRESETS tier for kvazaar/svtav1
    nvc_b_frames: bool = False         # NVC: bi-predicted odd frames
    nvc_me_radius: int = 4             # NVC: per-frame motion budget in pels
                                       # (>7 engages the hierarchical search)
    nvc_multi_ref: bool = False        # NVC: two-reference P prediction
    nvc_deblock: bool = True           # NVC: in-loop deblocking filter
    nvc_intra_pred: bool = True        # NVC: spatial intra prediction on
                                       # keyframes (DC/vert/gradient)
