"""Config-driven restoration backends (port of
``elvis_tpu.restore.backends``).

Every resolved backend has the restorer signature
``fn(frames, maps, block_size) -> frames``; the windowed inpaint backends
also take ``mv=`` (the expanded motion hint). Neural backends load the
port's committed weights (``elvis_tpu_torch/weights/<name>.npz``); without
the weights file an SR tier degrades to the classical progressive-Lanczos
restorer, the deblur net and the diffusion restorer to the unsharp mask
and the inpaint net to the temporal fill plus a short PDE pass, and the
provenance string says so.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from elvis_tpu_torch.core.blocks import dilate_block_mask, upsample_map
from elvis_tpu_torch.device import full_fp32, resolve_device
from elvis_tpu_torch.models.e2fgvi import dilate_hole, inpaint_video
from elvis_tpu_torch.models.io import (
    load_deblur,
    load_diffusion,
    load_e2fgvi,
    load_inpaint,
    load_srnet,
    srnet_arch,
    weights_path,
)
from elvis_tpu_torch.models.srnet import srnet_upsample_fn
from elvis_tpu_torch.ops.resize import resize
from elvis_tpu_torch.restore.hybrid import blended_restoration
from elvis_tpu_torch.restore.inpaint import restore_removal_diffusion, restore_removal_temporal
from elvis_tpu_torch.restore.lanczos import restore_downsample_lanczos
from elvis_tpu_torch.restore.level_seq import (
    level_sequential_restore,
    naive_diffusion_restore,
    naive_sr_restore,
)
from elvis_tpu_torch.restore.progressive import lanczos_upsample_2x, progressive_restore
from elvis_tpu_torch.restore.unsharp import restore_blur_unsharp

__all__ = ["resolve_sr_backend", "resolve_deblur_backend", "resolve_inpaint_backend",
           "default_params_path"]

BackendFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

# the architecture each pinned tier's weights must hold (the student's
# width and depth live in its file, so any SRNetCompact is a student);
# realesrgan_x2plus is Real-ESRGAN's published 2x RRDBNet, which ships no
# weights: it loads only from a configured srnet_params_path
_TIER_ARCH = {"srnet": ("srnet", 128, 128, 3), "srnet_compact": ("compact", 128, 5),
              "srnet_large": ("compact", 256, 8), "srnet_student": None,
              "realesrgan_x2plus": ("realesrgan", 64, 32, 23, 2)}
_ENSEMBLE = ("srnet_compact", "srnet", "srnet_large")


def default_params_path(name: str, configured: Optional[str], auto: bool) -> Optional[str]:
    """The configured weights file wins; else the shipped
    ``weights/<name>.npz`` when auto-load is on and it exists."""
    if configured:
        return configured if os.path.isfile(configured) else None
    if not auto:
        return None
    return weights_path(name)


def _with_full_fp32(up: Callable) -> Callable:
    """``up`` (and its ``phase_fn``) run with every float32 product at full
    float32 precision: ``realesrgan_fp32``, the counterpart of the JAX
    package's ``default_matmul_precision("float32")``. The SR nets' tails
    and the Lanczos base already run so; the bf16 trunk is untouched."""

    def fp32(x):
        with full_fp32():
            return up(x)

    phase = getattr(up, "phase_fn", None)
    if phase is not None:
        def fp32_phase(x):
            with full_fp32():
                return phase(x)

        fp32.phase_fn = fp32_phase
    return fp32


def _sr_meta(path: str) -> dict:
    """The scalar hyper-parameters of an SR weights file (no arrays read)."""
    with np.load(path) as data:
        return {k: data[k].item() for k in data.files if "/" not in k}


def _srnet_upsampler(config, which: Optional[str], device) -> Tuple[Optional[Callable], str]:
    """(2x upsample_fn or None, provenance), in the JAX package's order.
    ``which`` pins a tier ('srnet' RRDB, 'srnet_compact', 'srnet_large',
    'srnet_student', 'srnet_4k', 'realesrgan_x2plus') or the ensemble
    ('srnet_ensemble' / 'ensemble': the tiers that load averaged, compact + RRDB + large, only
    off the shipped files). None, the generic slot, takes the student, then
    the ensemble, then the first of large, compact, RRDB whose architecture
    a configured ``srnet_params_path`` holds (the JAX package's restore
    fails on any other tier's shapes). None => progressive Lanczos (what a
    zero-initialized SRNet computes). ``realesrgan_fp32`` appends ``+fp32``
    to a loaded provenance, as in the JAX package."""
    auto = getattr(config, "auto_load_checkpoints", True)

    def finish(fn, prov):
        if getattr(config, "realesrgan_fp32", False):
            return _with_full_fp32(fn), f"{prov}+fp32"
        return fn, prov

    def load_tier(name):
        path = default_params_path(name, config.srnet_params_path, auto)
        if not path:
            return None, ""
        try:
            arch = srnet_arch(_sr_meta(path))
        except KeyError:  # not an SR weights file
            arch = None
        want = _TIER_ARCH[name]
        fits = arch == want if want else arch is not None and arch[0] == "compact"
        if not fits:
            raise ValueError(f"{path} holds {arch}, not the {name} tier's architecture")
        return srnet_upsample_fn(load_srnet(path, device)), path

    def load_ensemble():
        # one configured srnet_params_path names ONE file; the ensemble needs
        # the shipped tiers, so it only forms off the shipped paths
        if config.srnet_params_path:
            return None, ""
        loaded = [load_tier(n) for n in _ENSEMBLE]
        fns = [fn for fn, _ in loaded if fn is not None]
        if len(fns) < 2:
            return None, ""
        k = float(len(fns))

        def ens(f):
            return sum(fn(f) for fn in fns) / k

        # averaging commutes with the final interleave: the ensemble runs in
        # phase form too
        phase_fns = [fn.phase_fn for fn in fns]
        ens.phase_fn = lambda f: sum(p(f) for p in phase_fns) / k
        return ens, "srnet_ensemble[" + " + ".join(p for fn, p in loaded if fn) + "]"

    if which == "srnet_4k":
        # the 4K tier needs a trained finisher (checkpoints/srnet_4k in the
        # JAX package); none ships, so both packages run progressive Lanczos
        return None, "lanczos (no 4k finisher checkpoint)"
    if which in _TIER_ARCH:
        fn, path = load_tier(which)
        if fn is not None:
            return finish(fn, f"{which}:{path}")
        return None, "lanczos (no SR checkpoint)"
    if which in ("srnet_ensemble", "ensemble"):
        fn, prov = load_ensemble()
        if fn is not None:
            return finish(fn, prov)
        # fall through to the single tiers when a file is missing
    if not config.srnet_params_path:
        fn, path = load_tier("srnet_student")
        if fn is not None:
            return finish(fn, f"srnet_student:{path}")
    fn, prov = load_ensemble()
    if fn is not None:
        return finish(fn, prov)
    for name in ("srnet_large", "srnet_compact", "srnet"):
        try:
            fn, path = load_tier(name)
        except ValueError:  # a configured file of another tier's architecture
            continue
        if fn is not None:
            return finish(fn, f"{name}:{path}")
    return None, "lanczos (no SR checkpoint)"


def resolve_sr_backend(name: str, config,
                       device: "str | torch.device" = "cuda") -> Tuple[BackendFn, str]:
    """Downsample-restoration backends: 'realesrgan' / 'progressive_neural'
    (the measured-best shipped tier: student, ensemble, large, compact,
    RRDB), 'srnet' (RRDB), 'srnet_student', 'srnet_large', 'srnet_compact'
    (each progressive neural, falling back to Lanczos without weights),
    'realesrgan_x2plus' (Real-ESRGAN's published 2x RRDBNet, progressive
    neural from the weights file ``config.srnet_params_path`` names, which
    must hold that architecture; Lanczos without one),
    'srnet_ensemble' / 'ensemble' (compact, RRDB and large averaged),
    'srnet_4k' (progressive Lanczos: no 4K finisher ships),
    'progressive_lanczos', 'lanczos' (per block, through the
    transform kernel), 'hybrid' (per-block Lanczos plus 0.1 x the
    progressive neural result, weighted by level), 'level_seq' (per level:
    an area resize by ``2**level``, then ``level`` upsamples) and
    'naive_sr' (map-blind whole-frame 2x SR, then an area resize back).
    Neural weights load onto ``device``.

    The config's SR runtime knobs ride on every returned function but
    'lanczos' and 'progressive_lanczos', as in the JAX package:
    ``realesrgan_tile`` (> 0) asks the stage driver for height tiling at
    ``tile * tile`` pixels a call with a halo of
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

    def lanczos_progressive(f, m, b):
        return progressive_restore(f, m, b, upsample_fn=lanczos_upsample_2x)

    if name == "progressive_lanczos":
        return lanczos_progressive, "progressive_lanczos"
    if name == "lanczos":
        return restore_downsample_lanczos, "lanczos"
    dev = resolve_device(device)
    pinned = (*_TIER_ARCH, "srnet_4k", "srnet_ensemble", "ensemble")
    if name in ("realesrgan", "progressive_neural") or name in pinned:
        which = name if name in pinned else None
        up, prov = _srnet_upsampler(config, which, dev)
        if up is None:
            return knobs(lanczos_progressive, prov)
        return knobs(lambda f, m, b: progressive_restore(f, m, b, upsample_fn=up),
                     f"progressive_neural[{prov}]")
    if name not in ("hybrid", "level_seq", "naive_sr"):
        raise ValueError(f"unknown SR backend {name!r}")
    up, prov = _srnet_upsampler(config, None, dev)
    if name == "naive_sr":
        return knobs(lambda f, m, b: naive_sr_restore(f, m, b, upsample_fn=up),
                     f"naive_sr[{prov}]")
    up = up or lanczos_upsample_2x
    if name == "hybrid":
        def hybrid(f, m, b):
            classical = restore_downsample_lanczos(f, m, b)
            neural = progressive_restore(f, m, b, upsample_fn=up)
            return blended_restoration(classical, neural, m, b, alpha=0.1)

        return knobs(hybrid, f"hybrid[lanczos + 0.1*{prov}]")

    def per_level(frames, lvl):
        h, w = frames.shape[-3], frames.shape[-2]
        small = resize(frames.float(), (h // 2**lvl, w // 2**lvl), method="area")
        for _ in range(lvl):
            small = up(small)
        return small

    def level_seq(f, m, b):
        max_level = max(int(m.max()), 1)  # host metadata
        return level_sequential_restore(per_level, f, m, b, max_level)

    return knobs(level_seq, f"level_seq[{prov}]")


def resolve_deblur_backend(name: str, config,
                           device: "str | torch.device" = "cuda") -> Tuple[BackendFn, str]:
    """Blur-restoration backends: 'deblur_net' (alias 'neural', 'instantir':
    the trained DeblurUNet, conditioned with the ``max_strength`` its
    weights file records; the unsharp mask without weights), 'unsharp'
    (classical), 'diffusion' (the shipped DiffusionRestorer's adaptive
    restore at ``gaussian_max_rounds``; the unsharp mask without weights)
    and 'naive_diffusion' (the untrained sampler on whole frames). The
    nets' weights load onto ``device``.

    'diffusion' draws its SDEdit noise on every call from a fresh
    ``torch.Generator`` on the frames' device seeded ``instantir_seed``
    (0 when None), in the chunk's shape: every chunk of one shape gets the
    same noise, whatever the chunk order, as the JAX package's one key
    gives. Its frames per call are ``instantir_batch_size``, bounded
    further by ``instantir_parallel_chunk_length``.

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
    if name == "diffusion":
        path = default_params_path("diffusion", None, auto)
        if not path:
            # an untrained diffusion model hallucinates noise: never a fallback
            return knobs(unsharp, "unsharp (no diffusion checkpoint)")
        model = load_diffusion(path, resolve_device(device))
        seed = 0 if config.instantir_seed is None else int(config.instantir_seed)

        # PRESLEY's instantir_steps: denoising steps per strength
        # round (0 or absent: the model's default)
        spr = int(getattr(config, "instantir_steps", 0) or 0)
        spr_kw = {"steps_per_round": spr} if spr > 0 else {}

        def diffusion(f, m, b):
            gen = torch.Generator(device=f.device).manual_seed(seed)
            out = model.restore_adaptive(f, m, b, max_rounds=max_rounds, generator=gen,
                                         **spr_kw)
            if not f.dtype.is_floating_point:
                out = torch.clamp(torch.round(out), 0, 255)
            return out.to(f.dtype)

        batch = int(config.instantir_batch_size or 0)
        if batch > 0:
            diffusion.frame_chunk = min(batch, int(stage_chunk)) if stage_chunk else batch
        elif stage_chunk:
            diffusion.frame_chunk = int(stage_chunk)
        diffusion.net = model
        return diffusion, f"diffusion:{path}[seed={seed}]"
    if name == "naive_diffusion":
        return knobs(lambda f, m, b: naive_diffusion_restore(f, m, b), "naive_diffusion")
    raise ValueError(f"unknown deblur backend {name!r}")


def _with_hole_dilation(fn, dilation_px: int):
    """Dilate the hole mask by ``dilation_px // block_size`` blocks before
    restoring: the ProPainter/E2FGVI ``mask_dilation`` knobs, in pixels,
    at block granularity (a sub-block dilation rounds down to none)."""
    if int(dilation_px) <= 0:
        return fn

    def wrapped(f, m, b, *a, **kw):
        r = int(dilation_px) // int(b)
        if r > 0:
            m = dilate_block_mask(m, r).to(m.dtype)
        return fn(f, m, b, *a, **kw)

    return wrapped


def _with_resize_ratio(fn, ratio: float):
    """Run an inpaint restorer at ``ratio`` of the input resolution, then
    upscale and put back only the hole pixels (``propainter_resize_ratio``):
    known pixels never round-trip the resize."""
    if not 0 < float(ratio) < 1.0:
        return fn

    def wrapped(f, m, b, mv=None, **kw):
        b_small = max(int(round(int(b) * float(ratio))), 1)
        by, bx = m.shape[-2], m.shape[-1]
        h, w = f.shape[1], f.shape[2]
        small = resize(f.float(), (by * b_small, bx * b_small), method="area")
        if mv is not None:  # pixel motion scales with the working resolution
            mv = torch.round(mv.float() * (b_small / int(b))).to(torch.int32)
        out = resize(fn(small, m, b_small, mv=mv, **kw).float(), (h, w), method="linear")
        hole = upsample_map(m.bool(), int(b))[..., None]
        out = torch.where(hole, out, f.float())
        if not f.dtype.is_floating_point:
            out = torch.clamp(torch.round(out), 0, 255)
        return out.to(f.dtype)

    return wrapped


def _propainter_window(config) -> int:
    """Propagation window from the ProPainter knobs: twice
    ``neighbor_length`` frames each side, bounded so that 2w+1 frames fit
    ``subvideo_length``."""
    w = 2 * max(int(config.propainter_neighbor_length), 1)
    cap = max((int(config.propainter_subvideo_length) - 1) // 2, 1)
    return max(min(w, cap), 1)


def _e2fgvi_window(config) -> int:
    """Seed window from the E2FGVI knobs: its chunk overlap,
    ``2 * neighbor_stride`` frames of context."""
    return max(2 * int(config.e2fgvi_neighbor_stride), 1)


def _temporal_pde_fallback(config) -> Tuple[Callable, int]:
    """(fill, window): the E2FGVI slots without weights, the temporal fill
    at the E2FGVI window and reference set, then a 40-iteration PDE pass."""
    w = _e2fgvi_window(config)
    refs, nref = int(config.e2fgvi_ref_stride or 0), int(config.e2fgvi_num_ref)

    def fallback(f, m, b, mv=None):
        seed = restore_removal_temporal(f, m, b, window=w, ref_stride=refs, max_refs=nref,
                                        motion_field=mv)
        return restore_removal_diffusion(seed, m, b, iters=40)

    return fallback, w


def _e2fgvi_hq_backend(config, device) -> Tuple[BackendFn, str]:
    """'e2fgvi_hq': the E2FGVI fields drive ``test.py``'s loop (local
    windows of ``e2fgvi_neighbor_stride`` around every such frame, reference
    frames every ``e2fgvi_ref_stride``, at most ``e2fgvi_num_ref`` of them,
    -1 for all), the removed blocks' pixels dilated by
    ``e2fgvi_mask_dilation`` 3x3 crosses as ``test.py`` dilates its masks;
    the motion hint is not read (the net computes its own flows). Frames
    in, frames of the same dtype out, uint8 values. Resolving it on a card
    turns on cuDNN's algorithm search for the process: at 1080p cuDNN's
    heuristics took a kernel without tensor cores for some of the net's
    bf16 convs."""
    ns, rs = int(config.e2fgvi_neighbor_stride), int(config.e2fgvi_ref_stride)
    nref, dil = int(config.e2fgvi_num_ref), int(config.e2fgvi_mask_dilation or 0)
    path = default_params_path("e2fgvi_hq", config.inpaint_params_path,
                               getattr(config, "auto_load_checkpoints", True))
    overlap = int(config.e2fgvi_chunk_overlap or 4 * ns)
    chunk = config.e2fgvi_parallel_chunk_length

    def knobs(fn):
        fn.temporal_overlap = overlap
        if chunk:
            fn.frame_chunk = int(chunk)
        return fn

    if not path:
        fallback, w = _temporal_pde_fallback(config)
        return (knobs(_with_hole_dilation(fallback, dil)),
                f"temporal+pde (no e2fgvi_hq checkpoint)[window={w}]")
    dev = resolve_device(device)
    model = load_e2fgvi(path, dev)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True

    def e2fgvi_hq(f, m, b, mv=None):
        hole = dilate_hole(upsample_map(m.bool(), int(b)), dil)
        with torch.inference_mode():
            out = inpaint_video(model, f, hole, ns, rs, nref)
        return out if f.dtype == torch.uint8 else out.to(f.dtype)

    fn = knobs(e2fgvi_hq)
    fn.net = model
    return (fn, f"e2fgvi_hq:{path}[neighbor_stride={ns},ref_stride={rs},num_ref={nref},"
            f"overlap={overlap}]")


def resolve_inpaint_backend(name: str, config,
                            device: "str | torch.device" = "cuda") -> Tuple[BackendFn, str]:
    """Removal-restoration backends: 'diffusion' (the PDE fill, the
    counterpart of OpenCV's Telea fill), 'temporal' (motion propagation,
    the ProPainter counterpart), 'neural' / 'inpaint_net' / 'e2fgvi'
    (InpaintNet over a temporal seed, the E2FGVI counterpart; without
    weights the seed plus a 40-iteration PDE pass) and 'e2fgvi_hq'
    (E2FGVI-HQ's published generator through ``test.py``'s loop,
    ``models.e2fgvi.inpaint_video``, from the weights file
    ``config.inpaint_params_path`` names, which must hold that model; no
    weights ship, so without one it is the 'neural' fallback: the seed plus
    the PDE pass). The nets' weights load onto ``device``.

    A windowed backend carries ``temporal_overlap``: the context frames a
    frame chunk needs past each boundary for chunked == unchunked (twice the
    window; the ``*_chunk_overlap`` fields override it), and ``frame_chunk``
    from ``*_parallel_chunk_length``. The net's backend also carries
    ``split``: the seed alone, at its overlap, whose ``post`` is the net
    alone at the net's own window (2 frames) with a 16-row halo for height
    tiling, so the net's feature maps never span the seed's wide window."""
    if name == "diffusion":
        return restore_removal_diffusion, "pde_diffusion"
    if name == "temporal":
        w = _propainter_window(config)
        ov = int(config.propainter_chunk_overlap or 2 * w)
        refs = int(config.propainter_ref_stride or 0)

        def temporal(f, m, b, mv=None):
            return restore_removal_temporal(f, m, b, window=w, ref_stride=refs, motion_field=mv)

        temporal = _with_hole_dilation(temporal, int(config.propainter_mask_dilation or 0))
        temporal = _with_resize_ratio(temporal, float(config.propainter_resize_ratio or 1.0))
        temporal.temporal_overlap = ov
        if config.propainter_parallel_chunk_length:
            temporal.frame_chunk = int(config.propainter_parallel_chunk_length)
        return temporal, f"temporal_propagation[window={w},overlap={ov},ref_stride={refs}]"
    if name == "e2fgvi_hq":
        return _e2fgvi_hq_backend(config, device)
    if name in ("neural", "inpaint_net", "e2fgvi"):
        w = _e2fgvi_window(config)
        ov = int(config.e2fgvi_chunk_overlap or 2 * w)
        # the non-local reference set: every ref_stride-th frame, at most num_ref
        refs = int(config.e2fgvi_ref_stride or 0)
        nref = int(config.e2fgvi_num_ref)
        dil = int(config.e2fgvi_mask_dilation or 0)
        chunk = config.e2fgvi_parallel_chunk_length

        def seed_fill(f, m, b, mv=None):
            return restore_removal_temporal(f, m, b, window=w, ref_stride=refs, max_refs=nref,
                                            motion_field=mv)

        def knobs(fn, overlap=ov):
            fn.temporal_overlap = overlap
            if chunk:
                fn.frame_chunk = int(chunk)
            return fn

        path = default_params_path("inpaint", config.inpaint_params_path,
                                   getattr(config, "auto_load_checkpoints", True))
        if not path:
            fallback, _ = _temporal_pde_fallback(config)
            return (knobs(_with_hole_dilation(fallback, dil)),
                    f"temporal+pde (no inpaint checkpoint)[window={w}]")
        net = load_inpaint(path, resolve_device(device))

        def net_fill(f, m, b):
            with torch.inference_mode():
                return net(f, m, b)

        def neural(f, m, b, mv=None):
            return net_fill(seed_fill(f, m, b, mv=mv).float(), m, b)

        neural = knobs(_with_hole_dilation(neural, dil))
        # seed + post == neural: the net's edge-clamped neighbour shifts
        # reach only the outermost temporal_window frames of a window,
        # which the post's own overlap trims
        seed = knobs(_with_hole_dilation(lambda f, m, b, mv=None: seed_fill(f, m, b, mv).float(),
                                         dil))
        post = knobs(_with_hole_dilation(net_fill, dil), overlap=net.temporal_window)
        # the net's receptive field: a 3x3 stack with one stride-2 level
        # reaches ~12 rows; 16 is the block-aligned bound
        post.spatial_halo_rows = 16
        seed.post = post
        neural.split = seed
        return neural, f"inpaint_net:{path}[window={w},overlap={ov}]"
    raise ValueError(f"unknown inpaint backend {name!r}")
