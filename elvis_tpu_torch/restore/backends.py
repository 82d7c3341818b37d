"""Config-driven restoration backends (port of the single-tier SR part,
the deblur part and the ``'diffusion'`` inpaint slot of
``elvis_tpu.restore.backends``).

Every resolved backend has the restorer signature
``fn(frames, maps, block_size) -> frames``. Neural backends load the
port's committed weights (``elvis_tpu_torch/weights/<name>.npz``); without
the weights file an SR tier degrades to the classical progressive-Lanczos
restorer and the deblur net to the unsharp mask, and the provenance string
says so.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.models.io import load_deblur, load_srnet, weights_path
from elvis_tpu_torch.models.srnet import srnet_upsample_fn
from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x, progressive_restore
from elvis_tpu_torch.restore.unsharp import restore_blur_unsharp

__all__ = ["resolve_sr_backend", "resolve_deblur_backend", "resolve_inpaint_backend",
           "default_params_path"]

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
    'progressive_lanczos'. Neural weights load onto ``device``.

    The config's SR runtime knobs ride on the returned function for the
    pipeline's stage driver: ``realesrgan_tile`` (> 0) asks for height
    tiling at ``tile * tile`` pixels a call with a halo of
    ``max(32, realesrgan_tile_pad)`` rows, ``realesrgan_parallel_chunk_length``
    bounds the frames a call."""

    def knobs(fn, prov):
        tile = int(getattr(config, "realesrgan_tile", 0) or 0)
        if tile > 0:
            fn.spatial_halo_rows = max(32, int(getattr(config, "realesrgan_tile_pad", 10) or 0))
            fn.spatial_pixel_budget = tile * tile
        chunk = getattr(config, "realesrgan_parallel_chunk_length", None)
        if chunk:
            fn.frame_chunk = int(chunk)
        return fn, prov

    if name == "progressive_lanczos":
        return (lambda f, m, b: progressive_restore(f, m, b, upsample_fn=lanczos_upsample_2x),
                "progressive_lanczos")
    if name == "realesrgan" or name in _TIERS:
        up, prov = _srnet_upsampler(config, None if name == "realesrgan" else name,
                                    resolve_device(device))
        if up is None:
            return (lambda f, m, b: progressive_restore(f, m, b, upsample_fn=lanczos_upsample_2x),
                    prov)
        return knobs(lambda f, m, b: progressive_restore(f, m, b, upsample_fn=up),
                     f"progressive_neural[{prov}]")
    raise ValueError(f"unknown SR backend {name!r}")


def resolve_deblur_backend(name: str, config,
                           device: "str | torch.device" = "cuda") -> Tuple[BackendFn, str]:
    """Blur-restoration backends: 'deblur_net' (alias 'neural', 'instantir':
    the trained DeblurUNet, conditioned with the ``max_strength`` its
    weights file records; the unsharp mask without weights) and 'unsharp'
    (classical). The net's weights load onto ``device``.

    A backend returns frames in the input dtype (uint8 in: rounded and
    clipped uint8 out). The net bounds its own memory: it runs
    ``spatial_pixel_budget // (H*W)`` frames per call, at least one, and at
    most ``config.instantir_parallel_chunk_length`` when that is set; the
    backend carries ``frame_chunk``, ``spatial_halo_rows`` and
    ``spatial_pixel_budget`` for a caller that tiles or chunks to read, and
    the loaded module as ``net``."""
    max_rounds = config.gaussian_max_rounds
    auto = getattr(config, "auto_load_checkpoints", True)
    stage_chunk = getattr(config, "instantir_parallel_chunk_length", None)

    def knobs(fn, prov):
        if stage_chunk:
            fn.frame_chunk = int(stage_chunk)
        return fn, prov

    def unsharp(f, m, b):
        return restore_blur_unsharp(f, m, b, max_rounds)

    if name == "unsharp":
        return knobs(unsharp, "unsharp")
    if name in ("deblur_net", "neural", "instantir"):
        path = default_params_path("deblur", config.deblur_params_path, auto)
        if not path:
            return knobs(unsharp, "unsharp (no deblur checkpoint)")
        net = load_deblur(path, resolve_device(device))

        def deblur(f, m, b):
            hw = f.shape[-3] * f.shape[-2]
            chunk = max(1, deblur.spatial_pixel_budget // hw)
            chunk = min(chunk, getattr(deblur, "frame_chunk", chunk))
            with torch.inference_mode():
                out = torch.cat([net(f[i:i + chunk], m[i:i + chunk], b)
                                 for i in range(0, f.shape[0], chunk)])
                if not f.dtype.is_floating_point:
                    out = torch.clamp(torch.round(out), 0, 255)
                return out.to(f.dtype)

        # Three stride-2 levels compound to a receptive field of about 51
        # rows; 64 is the block-aligned halo for height tiling.
        deblur.net = net
        deblur.spatial_halo_rows = 64
        deblur.spatial_pixel_budget = 3 << 20
        return knobs(deblur, f"deblur_net:{path}")
    if name in ("diffusion", "naive_diffusion"):
        raise ValueError(f"deblur backend {name!r} is not ported yet: it needs the "
                         "diffusion restorer (models/diffusion.py)")
    raise ValueError(f"unknown deblur backend {name!r}")


def resolve_inpaint_backend(name: str, config) -> Tuple[BackendFn, str]:
    """Removal-restoration backends: 'diffusion' (the PDE fill, the
    counterpart of OpenCV's Telea fill). 'temporal' (motion propagation)
    and 'neural' / 'inpaint_net' / 'e2fgvi' (InpaintNet over a temporal
    seed) are not ported yet."""
    from elvis_tpu_torch.restore.inpaint import restore_removal_diffusion

    if name == "diffusion":
        return restore_removal_diffusion, "pde_diffusion"
    if name in ("temporal", "neural", "inpaint_net", "e2fgvi"):
        raise NotImplementedError(
            f"inpaint backend {name!r}: not ported yet (ROADMAP.md §1 item 3, "
            "restore_removal_temporal, InpaintNet and the 'temporal'/'neural' backends)")
    raise ValueError(f"unknown inpaint backend {name!r}")
