"""Config-driven SR backend resolution (port of the single-tier part of
``elvis_tpu.restore.backends``).

Every resolved backend has the restorer signature
``fn(frames, maps, block_size) -> frames``. Neural tiers load the port's
committed weights (``elvis_tpu_torch/weights/<tier>.npz``); a missing
weights file degrades to the classical progressive-Lanczos restorer.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.models.io import load_srnet, weights_path
from elvis_tpu_torch.models.srnet import srnet_upsample_fn
from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x, progressive_restore

__all__ = ["resolve_sr_backend", "default_params_path"]

BackendFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

# single tiers, measured-best first (the JAX package's order without the
# ensemble, which is not ported yet)
_TIERS = ("srnet_student", "srnet_large", "srnet_compact")


def default_params_path(name: str, configured: Optional[str], auto: bool) -> Optional[str]:
    """The configured weights file wins; else the shipped
    ``weights/<name>.npz`` when auto-load is on and it exists."""
    if configured:
        return configured if os.path.isfile(configured) else None
    if not auto:
        return None
    return weights_path(name)


def _srnet_upsampler(config, which: Optional[str], device) -> Tuple[Optional[Callable], str]:
    """(2x upsample_fn or None, provenance). ``which`` pins a tier; None
    takes the first tier whose weights exist. None => progressive Lanczos
    (what a zero-initialized SRNet computes)."""
    auto = getattr(config, "auto_load_checkpoints", True)
    for name in (which,) if which else _TIERS:
        path = default_params_path(name, config.srnet_params_path, auto)
        if path:
            return srnet_upsample_fn(load_srnet(path, device)), f"{name}:{path}"
    return None, "lanczos (no SR checkpoint)"


def resolve_sr_backend(name: str, config,
                       device: "str | torch.device" = "cuda") -> Tuple[BackendFn, str]:
    """Downsample-restoration backends: 'realesrgan' (the measured-best
    shipped tier), 'srnet_student', 'srnet_large', 'srnet_compact' (each
    progressive neural, falling back to Lanczos without weights) and
    'progressive_lanczos'. Neural weights load onto ``device``."""
    if name == "progressive_lanczos":
        return (lambda f, m, b: progressive_restore(f, m, b, upsample_fn=lanczos_upsample_2x),
                "progressive_lanczos")
    if name == "realesrgan" or name in _TIERS:
        up, prov = _srnet_upsampler(config, None if name == "realesrgan" else name,
                                    resolve_device(device))
        if up is None:
            return (lambda f, m, b: progressive_restore(f, m, b, upsample_fn=lanczos_upsample_2x),
                    prov)
        return (lambda f, m, b: progressive_restore(f, m, b, upsample_fn=up),
                f"progressive_neural[{prov}]")
    raise ValueError(f"unknown SR backend {name!r}")
