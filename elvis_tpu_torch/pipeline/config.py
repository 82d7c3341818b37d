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
    removability_alpha: float = 0.5
    removability_smoothing_beta: float = 0.5
    saliency_backend: str = "motion_contrast"
    # 'realesrgan' = the generic slot: resolves to the measured-best tier
    # whose weights ship (srnet_student > srnet_large > srnet_compact).
    sr_backends: List[str] = field(default_factory=lambda: ["realesrgan"])
    auto_load_checkpoints: bool = True
    # path of a port weights file (.npz) that pins the SR net
    srnet_params_path: Optional[str] = None
