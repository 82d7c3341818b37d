"""run_elvis: the full pipeline orchestrator (port of
``elvis_tpu.pipeline.run``).

Stages, approach labels and the ``analysis_results.json`` schema are the
JAX package's: preprocessing, removability, baseline encode, ELVIS shrink,
ROI encode, downsample branch, blur branch, DCT-dampen branch (when
``enable_dct_dampen``), client stretch + inpainting, SR restore, deblur
restore, bitrate accounting, classical benchmarks, evaluation.

The clip is ONE uint8 tensor on the device; every stage runs there and the
only host work is entropy coding (NVC), the sidecars, the stage cache and
JSON. Stages that build clip-sized float32 temporaries run in frame chunks
under a pixel budget (``_FRAME_CHUNK_PIXEL_BUDGET``; a backend's
``frame_chunk``, ``spatial_halo_rows`` and ``spatial_pixel_budget`` bound
it further, and a net whose frame still busts its budget runs in height
tiles), so a 128-frame 1080p clip fits one card.

With ``data_parallel`` and more than one device (``parallel.mesh.devices``),
the per-frame and temporal stages shard the frame axis over a mesh
(``_DataParallel``, the JAX package's: pad, shard, run, trim; temporal
stages exchange halo frames), each stage over its own device list
(``propainter_devices``, ``e2fgvi_devices``, ``realesrgan_devices``,
``instantir_devices``), and frames at least ``spatial_tile_threshold``
tall restore in height tiles over a data x spatial mesh
(``spatial_devices``, ``spatial_halo``). On one card none of that runs.

  label                  slot                        backend here
  ------------------------------------------------------------------------
  Baseline               plain encode                codec.dispatch (nvc, x265,
                                                     kvazaar, svtav1)
  PRESLEY QP             per-block delta-QP ROI      NVC's native QP map, or
                                                     the encoder's ROI file
  ELVIS CV2              classical inpaint           PDE diffusion fill
  ELVIS ProPainter       flow-guided propagation     temporal propagation fill
  ELVIS E2FGVI           learned video inpaint       InpaintNet over a temporal seed
  PRESLEY RealESRGAN     neural progressive SR       srnet_student (shipped)
  PRESLEY InstantIR      neural deblur               DeblurUNet (shipped)
  PRESLEY Lanczos        classical SR benchmark      per-block Lanczos
  PRESLEY Unsharp        classical deblur benchmark  unsharp mask
  ELVIS v2 Dampen        DCT dampening (optional)    inverse filter
  (+ extra rows per sr_backends/deblur_backends/inpaint_backends entries)

Every field of the JAX package's config is ported (``minimal_figures`` is
read by the search drivers' figure roll-up, ``elvis_tpu_torch.search``, not
by a stage).
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from elvis_tpu_torch.codec import (
    calculate_target_bitrate,
    load_strength_maps_npz,
    load_strength_maps_video,
    save_removal_masks_npz,
    save_strength_maps_npz,
    save_strength_maps_video,
)
from elvis_tpu_torch.codec.dispatch import make_pipeline_codec
from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample, stretch_frames
from elvis_tpu_torch.degrade.dct_dampen import dct_dampen
from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.metrics.evaluate import analyze_encoding_performance
from elvis_tpu_torch.metrics.report import format_summary_report
from elvis_tpu_torch.parallel import mesh as _mesh
from elvis_tpu_torch.parallel.halo import spatial_tile_map_blocks, temporal_map_overlap
from elvis_tpu_torch.parallel.mesh import make_mesh, resolve_devices, shard_frames
from elvis_tpu_torch.pipeline.cache import StageCache
from elvis_tpu_torch.pipeline.config import ElvisConfig
from elvis_tpu_torch.pipeline.io import load_clip, save_frames_png
from elvis_tpu_torch.restore import (
    restore_blur_unsharp,
    restore_dct_dampen_inverse,
    restore_downsample_lanczos,
    temporal_blend,
)
from elvis_tpu_torch.restore.backends import (
    resolve_deblur_backend,
    resolve_inpaint_backend,
    resolve_sr_backend,
)
from elvis_tpu_torch.scoring import get_saliency_fn, importance_scores, removability_scores
from elvis_tpu_torch.utils.transfer import as_pixels_u8

__all__ = ["run_elvis", "APPROACHES"]


class APPROACHES:
    BASELINE = "Baseline"
    ELVIS_V2_DAMPEN = "ELVIS v2 Dampen"
    PRESLEY_QP = "PRESLEY QP"
    ELVIS = "ELVIS"
    ELVIS_CV2 = "ELVIS CV2"
    ELVIS_PROP = "ELVIS ProPainter"
    ELVIS_E2FGVI = "ELVIS E2FGVI"
    PRESLEY_REALESRGAN = "PRESLEY RealESRGAN"
    PRESLEY_INSTANTIR = "PRESLEY InstantIR"
    PRESLEY_LANCZOS = "PRESLEY Lanczos"
    PRESLEY_UNSHARP = "PRESLEY Unsharp"


_FRAME_CHUNK_PIXEL_BUDGET = 1 << 24  # ~16M px a chunk: 8 frames at 1080p
# Max frames*rows*cols per full-resolution net call before height tiling;
# backends override it with a `spatial_pixel_budget` attribute.
_NET_PIXEL_BUDGET = 6 << 20


def _height_tile_plan(fn, shape, n_frames: int):
    """(halo_rows, window_rows) when ``fn`` asks for height tiling (a
    ``spatial_halo_rows`` attribute: a bound on its receptive-field radius)
    and a call's pixel count would bust its budget, else None."""
    halo = int(getattr(fn, "spatial_halo_rows", 0) or 0)
    if not halo:
        return None
    budget = int(getattr(fn, "spatial_pixel_budget", _NET_PIXEL_BUDGET))
    h, w = int(shape[1]), int(shape[2])
    win_rows = budget // max(n_frames * w, 1)
    if h <= win_rows:
        return None
    return halo, win_rows


def _apply_height_tiled(fn, arrays, halo: int, win_rows: int) -> torch.Tensor:
    """Run a same-resolution per-frame net over height tiles.

    Windows of ``tile + 2*halo`` rows are clamped inward at the frame
    borders, so the true image edge keeps its padding and every kept row
    sits further than ``halo`` from a tile boundary: the tiled output
    equals the untiled one up to float reassociation. Each array's row
    granularity is its height ratio (frames tile by pixel rows, block maps
    by block rows)."""
    f = arrays[0]
    n, h = int(f.shape[0]), int(f.shape[1])
    ratios = []
    for a in arrays:
        r = h // int(a.shape[1])
        if r * int(a.shape[1]) != h:
            raise ValueError("height-tiled arrays must divide the frame height")
        ratios.append(r)
    align = max(ratios)  # the coarsest map's block size, in rows
    halo = -(-halo // align) * align
    tile = max(((win_rows - 2 * halo) // align) * align, align)
    win = tile + 2 * halo
    if win >= h:
        return fn(*arrays)
    out = None
    for r0 in range(0, h, tile):
        r1 = min(r0 + tile, h)
        start = min(max(r0 - halo, 0), h - win)
        o = fn(*[a[:, start // r: (start + win) // r] for a, r in zip(arrays, ratios)])
        if o.shape[1] != win:
            raise ValueError("height-tiled ops must preserve frame height")
        if out is None:
            out = torch.empty((n, h) + tuple(o.shape[2:]), dtype=o.dtype, device=o.device)
        out[:, r0:r1] = o[:, r0 - start: r0 - start + (r1 - r0)]
    return out


def _scoring_features_chunked(frames: torch.Tensor, block_size: int, sal_fn, chunk: int):
    """Per-frame scoring features over 1-frame-haloed frame chunks.

    The halo keeps chunking exact: every saliency backend is computable
    from a +-1-frame window, and the clip-edge rules apply only where the
    window really is the clip edge. TC of an interior chunk's first frame
    differences against its true predecessor (the halo frame); the clip's
    first frame gets TC = 0.

    Returns SC, TC, the saliency block mean, the foreground block fraction
    (each (N,By,Bx) float32) and the (N,H,W) bool pixel foreground mask,
    all on the frames' device."""
    from elvis_tpu_torch.core.blocks import blockwise_reduce
    from elvis_tpu_torch.ops.color import rgb_to_gray
    from elvis_tpu_torch.scoring.complexity import texture_energy

    n = int(frames.shape[0])
    b = block_size
    outs = [[] for _ in range(5)]
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        w0, w1 = max(s - 1, 0), min(e + 1, n)
        f32 = frames[w0:w1].float()
        gray = rgb_to_gray(f32)
        sc = texture_energy(gray, b)
        diff = torch.cat([torch.zeros_like(gray[:1]), gray[1:] - gray[:-1]], dim=0)
        tc = texture_energy(diff, b)
        sal = sal_fn(f32)
        lo, hi = (1 if w0 < s else 0), sal.shape[0] - (1 if w1 > e else 0)
        sal, sc, tc = sal[lo:hi], sc[lo:hi], tc[lo:hi]
        fg_bits = sal >= 0.5
        res = (sc, tc, blockwise_reduce(sal.float(), b, torch.mean),
               blockwise_reduce(fg_bits.float(), b, torch.mean), fg_bits)
        for acc, r in zip(outs, res):
            acc.append(r)
    return tuple(torch.cat(o) for o in outs)


def _chunk_frames(shape, fn=None) -> int:
    """Frames a call of a per-frame stage: the pixel budget, bounded further
    by a backend's ``frame_chunk`` (the *_parallel_chunk_length knobs)."""
    h, w = int(shape[1]), int(shape[2])
    chunk = max(2, _FRAME_CHUNK_PIXEL_BUDGET // (h * w))
    configured = int(getattr(fn, "frame_chunk", 0) or 0) if fn is not None else 0
    if configured > 0:
        chunk = min(chunk, configured)
    return chunk


def _apply_framewise(fn, *arrays):
    """A per-frame op over bounded-memory frame chunks (exact): the path of
    ``_DataParallel.apply`` with no mesh, and what runs inside each shard."""
    n = int(arrays[0].shape[0])
    chunk = _chunk_frames(arrays[0].shape, fn)
    if getattr(fn, "spatial_halo_rows", 0):
        # per-frame nets: spend the pixel budget on the frame chunk first,
        # row-tile only when a single frame busts it
        budget = int(getattr(fn, "spatial_pixel_budget", _NET_PIXEL_BUDGET))
        hw = int(arrays[0].shape[1]) * int(arrays[0].shape[2])
        chunk = min(chunk, max(1, budget // hw))
    tiled = _height_tile_plan(fn, arrays[0].shape, min(n, chunk))
    outs = []
    for s in range(0, n, chunk):
        part = [a[s: s + chunk] for a in arrays]
        outs.append(_apply_height_tiled(fn, part, *tiled) if tiled else fn(*part))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _apply_temporal(fn, arrays, overlap: int):
    """A windowed op over frame chunks that see ``overlap`` context frames
    past each boundary, trimmed after (the reference's overlap-and-trim):
    the path of ``_DataParallel.apply_temporal`` with no mesh, and what
    runs inside each shard."""
    n = int(arrays[0].shape[0])
    chunk = _chunk_frames(arrays[0].shape, fn)
    tiled = _height_tile_plan(fn, arrays[0].shape, min(n, chunk + 2 * overlap))
    outs = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        lo, hi = max(0, s - overlap), min(n, e + overlap)
        part = [a[lo:hi] for a in arrays]
        out = _apply_height_tiled(fn, part, *tiled) if tiled else fn(*part)
        outs.append(out[s - lo: s - lo + (e - s)])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _device_key(device: torch.device) -> torch.device:
    """``cuda`` as the index it means (a tensor's device carries one), and
    ``cpu`` without one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if device.type == "cpu" else device


class _PerDevice:
    """A stage function per device. A backend whose weights live on the
    run's device is resolved once more for each other device a stage's mesh
    runs a shard on; ``map`` derives the argument-binding wrappers."""

    def __init__(self, make, known=None):
        self._make = make
        self._fns = {_device_key(d): fn for d, fn in (known or {}).items()}

    def on(self, device: torch.device):
        key = _device_key(device)
        if key not in self._fns:
            self._fns[key] = self._make(key)
        return self._fns[key]

    def map(self, wrap) -> "_PerDevice":
        return _PerDevice(lambda d: wrap(self.on(d)))


def _on(fn, device: torch.device):
    return fn.on(device) if isinstance(fn, _PerDevice) else fn


class _DataParallel:
    """Frame-axis data parallelism over a device mesh (the JAX package's).

    ``apply`` pads N up to a multiple of the mesh's data axis (edge-frame
    repeats), shards it, runs a per-frame op on each shard on its device and
    trims; ``apply_temporal`` also gives each shard ``overlap`` halo frames
    from its neighbours (``parallel.halo.temporal_map_overlap``), falling
    back to the unsharded call when a shard would be smaller than the
    window; ``apply_spatial`` restores tall frames in height tiles over a
    data x spatial mesh (``spatial_tile_map_blocks``). Inside a shard the
    one-card chunked calls bound the memory (exact for per-frame ops).

    No mesh (``data_parallel`` off, or one device): both entry points are
    ``_apply_framewise`` / ``_apply_temporal``. ``devices`` selects a
    stage's own device list; a list of one device means no mesh.
    ``fn`` is a callable or a ``_PerDevice``."""

    def __init__(self, enabled: bool, spatial: int = 0, device_type: str = "cuda"):
        self.mesh = None
        self.spatial_mesh = None
        self._submeshes = {}
        self.device_type = device_type
        n_dev = len(_mesh.devices(device_type)) if enabled else 0
        if n_dev > 1:
            self.mesh = make_mesh(device_type=device_type)
            if spatial > 1 and n_dev % spatial == 0:
                # data x spatial mesh for height-tiled full-frame restores
                self.spatial_mesh = make_mesh((("data", n_dev // spatial), ("spatial", spatial)),
                                              device_type=device_type)

    def _mesh_for(self, devices):
        """The mesh of a stage's device list (None: the full mesh)."""
        if devices is None or self.mesh is None:
            return self.mesh
        key = tuple(str(d) for d in devices)
        if key not in self._submeshes:
            n = len(resolve_devices(devices, self.device_type))
            self._submeshes[key] = (make_mesh(devices=devices, device_type=self.device_type)
                                    if n > 1 else None)
        return self._submeshes[key]

    def apply(self, fn, *arrays, devices=None) -> torch.Tensor:
        mesh = self._mesh_for(devices)
        home = arrays[0].device
        if mesh is None:
            return _apply_framewise(_on(fn, home), *arrays)
        n = int(arrays[0].shape[0])
        sharded = [shard_frames(a, mesh)[0] for a in arrays]
        outs = [_apply_framewise(_on(fn, d), *[s.shards[i] for s in sharded]).to(home)
                for i, d in enumerate(sharded[0].sharding.devices)]
        return torch.cat(outs)[:n]

    def apply_temporal(self, fn, arrays, overlap: int, devices=None,
                       pairwise: Tuple[bool, ...] = ()) -> torch.Tensor:
        """A windowed op over frame shards with ``overlap`` halo frames.
        ``pairwise[k]`` marks a per-pair array (the motion field): past the
        clip's end, where the frames are repeats of the last, it is zero."""
        mesh = self._mesh_for(devices)
        home = arrays[0].device
        n = int(arrays[0].shape[0])
        size = mesh.shape["data"] if mesh is not None else 1
        if mesh is None or (n + (-n) % size) // size < overlap:
            return _apply_temporal(_on(fn, home), arrays, overlap)
        pad = (-n) % size
        padded = tuple(shard_frames(torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
                                    if k < len(pairwise) and pairwise[k] and pad else a,
                                    mesh)[0]
                       for k, a in enumerate(arrays))
        out = temporal_map_overlap(
            lambda *ext: _apply_temporal(_on(fn, ext[0].device), ext, overlap),
            padded, mesh, overlap, zero_edge=pairwise)
        return out.to(home)[:n]

    def spatial_ok(self, height: int, block_size: int) -> bool:
        return (self.spatial_mesh is not None
                and height % (self.spatial_mesh.shape["spatial"] * block_size) == 0)

    def apply_spatial(self, fn, frames, levels, halo: int, block_size: int) -> torch.Tensor:
        """Frame DP x height tiles: a per-frame restore on 2-D shards with
        the pixel and block halos (``halo`` rounded down to a multiple of
        ``block_size``, at least one block)."""
        mesh = self.spatial_mesh
        home, n = frames.device, int(frames.shape[0])
        halo = max(block_size, halo - halo % block_size)
        out = spatial_tile_map_blocks(
            lambda f, lv: _apply_framewise(_on(fn, f.device), f, lv),
            shard_frames(frames, mesh)[0], shard_frames(levels, mesh)[0], mesh, halo,
            block_size, data_axis="data")
        return out.to(home)[:n]


def _apply_inpaint_backend(name, fn, stretched, removal_mask, b, motion_field=None,
                           dp: Optional[_DataParallel] = None, devices=None):
    """Stage 8 for one inpaint backend (the JAX package's), over
    ``dp``'s mesh for the stage's ``devices`` (no mesh when ``dp`` is None).

    'diffusion' is per-frame: plain frame shards and chunks. A windowed
    backend runs with its own ``temporal_overlap`` of context at every
    shard and chunk boundary; the motion field rides as one more frame-axis
    array, so a chunk's field is sliced with its frames (a chunk's first
    per-pair entry is never used), and past the clip's end, where a shard's
    halo repeats the last frame, the field is zero motion. A backend with ``split`` runs in two
    phases, the seed and then its ``post``, each at its own overlap: the
    net's feature maps never span the seed's wide window. seed + post
    equals the fused backend. ``fn`` is a callable or a ``_PerDevice``."""
    dp = dp or _DataParallel(False)
    if not isinstance(fn, _PerDevice):
        fn = _PerDevice(lambda d, one=fn: one)
    home = stretched.device
    if name == "diffusion":
        return dp.apply(fn.map(lambda g: lambda f, m: g(f, m, b)), stretched, removal_mask,
                        devices=devices)

    def windowed(g_pd):
        if motion_field is None:
            call = g_pd.map(lambda g: _carry_tiling(lambda f, m: g(f, m, b), g))
            arrays = (stretched, removal_mask)
        else:
            call = g_pd.map(lambda g: _carry_tiling(lambda f, m, mv: g(f, m, b, mv=mv), g))
            arrays = (stretched, removal_mask, motion_field)
        return dp.apply_temporal(call, arrays, devices=devices,
                                 overlap=getattr(g_pd.on(home), "temporal_overlap", 16),
                                 pairwise=(False, False, True))

    if getattr(fn.on(home), "split", None) is None:
        return windowed(fn)
    seeded = windowed(fn.map(lambda g: g.split))
    post = fn.map(lambda g: g.split.post)
    return dp.apply_temporal(post.map(lambda p: _carry_tiling(lambda f, m: p(f, m, b), p)),
                             (seeded, removal_mask), devices=devices,
                             overlap=getattr(post.on(home), "temporal_overlap", 2))


def _rss_gb() -> float:
    """Current process RSS in GB (0.0 where /proc is unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):
        return 0.0


class _StageTimes(dict):
    """execution_times dict that prints each stage's wall-clock as it lands,
    samples host RSS per stage into ``.rss_gb`` and, on a CUDA device, the
    peak allocated device memory since the previous entry into
    ``.peak_bytes``."""

    def __init__(self, verbose: bool, device: Optional[torch.device] = None):
        super().__init__()
        self._verbose = verbose
        self.rss_gb: Dict[str, float] = {}
        self.peak_bytes: Dict[str, int] = {}
        self._cuda = device if device is not None and device.type == "cuda" else None
        if self._cuda is not None:
            torch.cuda.reset_peak_memory_stats(self._cuda)

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        rss = _rss_gb()
        self.rss_gb[key] = round(rss, 2)
        if self._cuda is not None:
            self.peak_bytes[key] = torch.cuda.max_memory_allocated(self._cuda)
            torch.cuda.reset_peak_memory_stats(self._cuda)
        if self._verbose:
            try:
                print(f"[elvis_tpu_torch] {key}: {value:.1f}s (rss {rss:.1f} GB)", flush=True)
            except (ValueError, OSError):
                pass


def _carry_tiling(dst, src):
    """Copy height-tiling/chunking declarations from a backend onto its
    arg-binding wrapper so the stage drivers still see them."""
    for k in ("spatial_halo_rows", "spatial_pixel_budget", "frame_chunk"):
        v = getattr(src, k, None)
        if v:
            setattr(dst, k, v)
    return dst


def _sync(device: torch.device) -> None:
    """Stage times are wall-clock: wait for the card's queue before reading."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_elvis(config: ElvisConfig, device: "str | torch.device" = "cuda",
              stats: Optional[Dict] = None) -> Dict:
    """Execute the pipeline on ``device``; returns (and writes) the
    analysis results.

    ``stats``, when given, receives what the results' schema has no key
    for: ``"stage_peak_bytes"`` (peak allocated device memory over each
    stage; empty off CUDA) and ``"streams"`` (each encoded branch's
    bitstream bytes)."""
    dev = resolve_device(device)
    if config.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            result = _run_elvis_impl(config, dev, stats)
        os.makedirs(config.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(config.profile_dir, "trace.json"))
        return result
    return _run_elvis_impl(config, dev, stats)


def _ckpt_stamp(prov: str) -> list:
    """Freshness of the weights file a provenance string names: a
    re-exported file invalidates the cached restores made with the old one."""
    return [os.path.getmtime(p) for p in re.findall(r":(\S+?\.npz)", prov) if os.path.isfile(p)]


@torch.no_grad()
def _run_elvis_impl(config: ElvisConfig, dev: torch.device, stats: Optional[Dict]) -> Dict:
    t_pipeline = time.time()
    width, height, b = config.width, config.height, config.block_size

    video_name = Path(config.reference_video.replace("synthetic://", "synthetic_")).stem
    experiment_dir = config.experiment_dir or os.path.abspath(
        f"experiment_{video_name}_w{width}_h{height}_bs{b}_shrink{config.shrink_amount}"
    )
    os.makedirs(experiment_dir, exist_ok=True)
    maps_dir = os.path.join(experiment_dir, "maps")
    os.makedirs(maps_dir, exist_ok=True)

    execution_times: Dict[str, float] = _StageTimes(config.verbose, dev)
    approach_times = defaultdict(float)
    cache = StageCache(os.path.join(experiment_dir, "stage_cache"), config.stage_cache)

    def stage_done(name, t0):
        _sync(dev)
        dt = time.time() - t0
        execution_times[name] = dt
        return dt

    # --- stage 0: preprocessing ---------------------------------------------
    t0 = time.time()
    frames_np, framerate = load_clip(config.reference_video, width, height,
                                     config.max_frames, device=dev)
    if config.framerate_override:
        framerate = config.framerate_override
    n = frames_np.shape[0]
    duration = n / framerate
    target_bitrate = config.target_bitrate_override or calculate_target_bitrate(
        width, height, framerate, config.quality_factor
    )
    frames = torch.as_tensor(frames_np, device=dev)
    stage_done("Preprocessing", t0)

    # frame-axis data parallelism: per-frame stages pad N to a multiple of
    # the devices and shard; windowed stages also exchange halo frames
    dp = _DataParallel(config.data_parallel, spatial=config.spatial_devices,
                       device_type=dev.type)

    def _restore_framewise(fn, frames_in, maps_in, devices=None):
        """A per-frame restore: frame shards, or for tall frames with a
        spatial mesh axis configured, frame x height-tile shards."""
        bound = fn.map(lambda g: _carry_tiling(as_pixels_u8(lambda f, m: g(f, m, b)), g))
        if height >= config.spatial_tile_threshold and dp.spatial_ok(height, b):
            return dp.apply_spatial(bound, frames_in, maps_in, halo=config.spatial_halo,
                                    block_size=b)
        return dp.apply(bound, frames_in, maps_in, devices=devices)

    def _per_device(resolve, name, fn):
        """``fn`` (resolved on ``dev``), and the same backend on any other
        device a stage's mesh asks for."""
        return _PerDevice(lambda d: resolve(name, config, device=d)[0], {dev: fn})

    codec = make_pipeline_codec(
        config.codec, os.path.join(experiment_dir, "codec"), width, height,
        preset=config.encode_preset, pix_fmt=config.encode_pix_fmt,
        quality=config.quality_preset, nvc_b_frames=config.nvc_b_frames,
        nvc_me_radius=config.nvc_me_radius, nvc_multi_ref=config.nvc_multi_ref,
        nvc_deblock=config.nvc_deblock, nvc_intra_pred=config.nvc_intra_pred,
        device=dev,
    )
    # ~1-second keyframe interval
    gop = max(int(round(framerate)), 1)
    enc_kw = dict(target_bitrate=target_bitrate, framerate=framerate, gop=gop)

    # --- stage 1: removability scoring --------------------------------------
    t0 = time.time()

    def _score():
        chunk = max(1, _FRAME_CHUNK_PIXEL_BUDGET // (height * width))
        sc, tc, fg_pool, fg_frac, fg_pixel = _scoring_features_chunked(
            frames, b, get_saliency_fn(config.saliency_backend), chunk)
        scores = removability_scores(
            sc, tc, fg_pool >= 0.5,  # == saliency_to_block_mask(sal, b)
            alpha=config.removability_alpha,
            smoothing_beta=config.removability_smoothing_beta,
        )
        # PRESLEY importance for the ROI stage: a block counts as
        # foreground if any meaningful part of it is
        importance = importance_scores(
            sc, tc, (fg_frac > 0.1).float(),
            alpha=config.removability_alpha, beta=config.removability_smoothing_beta,
        )
        return {"scores": scores, "importance": importance, "fg_pixel": fg_pixel}

    # "v2": the JAX package's cache schema (the bool pixel mask)
    scored = cache.get_or_run("scoring", ["v2", config.to_dict(), frames_np], _score,
                              device=dev)
    scores = scored["scores"]
    importance = scored["importance"]
    if config.masks_dir:
        # external ground-truth masks override the saliency estimate
        from elvis_tpu_torch.pipeline.io import load_masks

        fg_masks_pixel = torch.as_tensor(load_masks(config.masks_dir, width, height, n,
                                                    device=dev),
                                         device=dev)
    else:
        fg_masks_pixel = scored["fg_pixel"].bool()  # (N,H,W)
    save_frames_png(
        (fg_masks_pixel.cpu().numpy() * 255).astype(np.uint8)[..., None].repeat(3, -1),
        os.path.join(maps_dir, "saliency_masks"),
    )
    stage_done("Removability Scores", t0)

    streams: Dict[str, bytes] = {}
    decoded: Dict[str, torch.Tensor] = {}
    sidecar_sizes: Dict[str, int] = {}

    # every encode branch is content-addressed on (config, input frames)
    _branch_key = [config.to_dict(), frames_np]
    chunk_f = _chunk_frames(frames.shape)

    # --- stage 2: baseline encode -------------------------------------------
    t0 = time.time()

    def _baseline():
        s = codec.encode(frames, **enc_kw)
        return {"stream": s, "decoded": codec.decode(s)}

    r = cache.get_or_run("baseline_encode", _branch_key, _baseline, device=dev)
    streams["baseline"] = r["stream"]
    decoded[APPROACHES.BASELINE] = r["decoded"]
    approach_times[APPROACHES.BASELINE] += stage_done("Baseline Encoding", t0)

    # --- stage 3: ELVIS shrink ----------------------------------------------
    t0 = time.time()

    def _shrink():
        # the removal mask over the WHOLE clip first (the cooldown carries
        # per-block state across frames), then the gather in frame chunks
        from elvis_tpu_torch.degrade.removal import (
            apply_removal_mask, removal_blocks_per_row, removal_mask_from_scores,
        )

        bx = width // b
        k = removal_blocks_per_row(bx, config.shrink_amount)
        mask_all = removal_mask_from_scores(scores, bx, config.shrink_amount,
                                            cooldown=config.shrink_removal_cooldown)
        shrunk = torch.cat([apply_removal_mask(frames[s0:s0 + chunk_f],
                                               mask_all[s0:s0 + chunk_f], b, k)
                            for s0 in range(0, n, chunk_f)])
        s = codec.encode(shrunk, **enc_kw)
        out = {"stream": s, "decoded": codec.decode(s), "removal_mask": mask_all}
        if config.inpaint_motion_hint and n > 1:
            # encoder-side motion hint for the client fill, from the
            # PRISTINE frames; pairs are independent -> chunks overlap by one
            from elvis_tpu_torch.ops.motion import motion_hint

            g_l, d_l = [], []
            for s0 in range(0, n - 1, chunk_f):
                g_, d_ = motion_hint(frames[s0:min(s0 + chunk_f + 1, n)], b)
                g_l.append(g_)
                d_l.append(d_)
            out["motion_gmv"] = torch.cat(g_l)
            out["motion_dev"] = torch.cat(d_l)
        return out

    r = cache.get_or_run("shrink_encode", _branch_key, _shrink, device=dev)
    streams["shrunk"] = r["stream"]
    shrunk_decoded = r["decoded"]
    removal_mask = r["removal_mask"]
    motion_gmv, motion_dev = r.get("motion_gmv"), r.get("motion_dev")
    masks_npz = os.path.join(experiment_dir, f"shrink_masks_{b}.npz")
    save_removal_masks_npz(
        removal_mask.cpu().numpy(), masks_npz,
        motion_gmv=None if motion_gmv is None else motion_gmv.cpu().numpy(),
        motion_dev=None if motion_dev is None else motion_dev.cpu().numpy())
    approach_times[APPROACHES.ELVIS] += stage_done("ELVIS Shrinking", t0)

    # --- stage 4: ROI encode (importance -> NVC's per-block delta-QP) -------
    t0 = time.time()

    def _roi():
        s = codec.encode_roi(
            frames, removability=scores.cpu().numpy(), importance=importance.cpu().numpy(),
            block_size=b, roi_qp_range=config.roi_qp_range, **enc_kw,
        )
        return {"stream": s, "decoded": codec.decode(s)}

    r = cache.get_or_run("roi_encode", _branch_key, _roi, device=dev)
    streams["roi"] = r["stream"]
    decoded[APPROACHES.PRESLEY_QP] = r["decoded"]
    approach_times[APPROACHES.PRESLEY_QP] += stage_done("Adaptive QP Encoding", t0)

    # strength-map sidecar: npz (lossless) or a video at
    # strength_maps_target_bitrate
    def _save_maps(levels, name):
        levels = levels.cpu().numpy()
        if config.strength_maps_use_npz:
            path = os.path.join(maps_dir, f"{name}_maps.npz")
            return path, save_strength_maps_npz(levels, path)
        path = os.path.join(maps_dir, f"{name}_maps.nvsv")
        return path, save_strength_maps_video(
            levels, path, framerate=framerate,
            target_bitrate=config.strength_maps_target_bitrate, device=dev,
        )

    def _load_maps(path):
        maps = (load_strength_maps_npz(path) if path.endswith(".npz")
                else load_strength_maps_video(path, device=dev))
        return torch.as_tensor(maps.astype(np.int32), device=dev)

    def _degrade_chunked(op):
        """(uint8 frames', levels) from a per-frame degrade op, in
        bounded-memory frame chunks."""
        fs, ls = [], []
        for s0 in range(0, n, chunk_f):
            fr, lv = op(frames[s0:s0 + chunk_f], scores[s0:s0 + chunk_f])
            if fr.dtype.is_floating_point:
                fr = torch.clamp(torch.round(fr), 0, 255)
            fs.append(fr.to(torch.uint8))
            ls.append(lv)
        return torch.cat(fs), torch.cat(ls)

    # --- stage 5: downsample branch ------------------------------------------
    t0 = time.time()

    def _downsample():
        down_frames, down_levels = _degrade_chunked(lambda f, sc: adaptive_downsample(f, sc, b))
        s = codec.encode(down_frames, **enc_kw)
        return {"stream": s, "decoded": codec.decode(s), "levels": down_levels}

    r = cache.get_or_run("downsample_encode", _branch_key, _downsample, device=dev)
    streams["downsampled"] = r["stream"]
    down_decoded = r["decoded"]
    down_maps_path, sidecar_sizes["downsample"] = _save_maps(r["levels"], "downsample")
    approach_times[APPROACHES.PRESLEY_REALESRGAN] += stage_done("Downsampled Encoding", t0)

    # --- stage 6: blur branch --------------------------------------------------
    t0 = time.time()

    def _gaussian():
        blur_frames, blur_levels = _degrade_chunked(
            lambda f, sc: adaptive_blur(f, sc, b, config.gaussian_max_rounds))
        s = codec.encode(blur_frames, **enc_kw)
        return {"stream": s, "decoded": codec.decode(s), "levels": blur_levels}

    r = cache.get_or_run("gaussian_encode", _branch_key, _gaussian, device=dev)
    streams["gaussian"] = r["stream"]
    blur_decoded = r["decoded"]
    blur_maps_path, sidecar_sizes["gaussian"] = _save_maps(r["levels"], "gaussian")
    approach_times[APPROACHES.PRESLEY_INSTANTIR] += stage_done("Gaussian Encoding", t0)

    # --- stage 6b: DCT-dampen branch (the "ELVIS v2" of the reference's README)
    if config.enable_dct_dampen:
        t0 = time.time()

        def _dampen():
            damp_frames, damp_levels = _degrade_chunked(lambda f, sc: dct_dampen(f, sc, b))
            s = codec.encode(damp_frames, **enc_kw)
            return {"stream": s, "decoded": codec.decode(s), "levels": damp_levels}

        r = cache.get_or_run("dampen_encode", _branch_key, _dampen, device=dev)
        streams["dampened"] = r["stream"]
        damp_maps_path, sidecar_sizes["dampen"] = _save_maps(r["levels"], "dampen")
        decoded[APPROACHES.ELVIS_V2_DAMPEN] = dp.apply(
            as_pixels_u8(lambda f, m: restore_dct_dampen_inverse(f, m, b)),
            r["decoded"], _load_maps(damp_maps_path))
        approach_times[APPROACHES.ELVIS_V2_DAMPEN] += stage_done("DCT Dampen Branch", t0)

    # --- stage 7: client stretch ---------------------------------------------
    t0 = time.time()
    stretched = dp.apply(lambda f, m: stretch_frames(f, m, b), shrunk_decoded, removal_mask)
    stage_done("ELVIS Stretching", t0)

    # --- stages 8-10: restoration through the config-driven backends ---------
    # The first entry of each *_backends list fills the reference's label;
    # extra entries add rows. backend_provenance records what ran.
    backend_provenance: Dict[str, str] = {}
    # label -> encoded branch whose bitrate the row inherits (stage 11)
    row_branch: Dict[str, str] = {}

    def _cached_restore(stage: str, prov: str, compute) -> torch.Tensor:
        """Restores resume too: keyed on (config, input frames, backend
        provenance, weights freshness)."""
        r_ = cache.get_or_run(stage, [_branch_key, prov, _ckpt_stamp(prov)],
                              lambda: {"frames": compute()}, device=dev)
        return r_["frames"]

    # --- stage 8: inpainting ---------------------------------------------------
    _inpaint_labels = {
        "diffusion": (APPROACHES.ELVIS_CV2, "CV2 Inpainting"),
        "temporal": (APPROACHES.ELVIS_PROP, "ProPainter Inpainting"),
        "neural": (APPROACHES.ELVIS_E2FGVI, "E2FGVI Inpainting"),
    }
    # each slot's stage shards over only its own devices
    _inpaint_devices = {"temporal": config.propainter_devices, "neural": config.e2fgvi_devices}
    # the transmitted motion hint, expanded to the fill grid once and shared
    # by every motion-consuming backend
    inpaint_motion = None
    if motion_gmv is not None and config.inpaint_motion_hint:
        from elvis_tpu_torch.ops.motion import motion_field_from_hint

        inpaint_motion = motion_field_from_hint(motion_gmv, motion_dev,
                                                int(removal_mask.shape[1]),
                                                int(removal_mask.shape[2]))
    for name in config.inpaint_backends:
        label, timer = _inpaint_labels.get(name, (f"ELVIS {name}", f"{name} Inpainting"))
        fn, prov = resolve_inpaint_backend(name, config, device=dev)
        mv_arg = inpaint_motion if name != "diffusion" else None
        if mv_arg is not None:
            prov = f"{prov}+motion_hint"
        backend_provenance[label] = prov
        row_branch[label] = "shrunk"
        t0 = time.time()
        decoded[label] = _cached_restore(
            f"inpaint_{name}", prov,
            lambda fn=fn, name=name, mv_arg=mv_arg: _apply_inpaint_backend(
                name, _per_device(resolve_inpaint_backend, name, fn), stretched, removal_mask,
                b, motion_field=mv_arg, dp=dp, devices=_inpaint_devices.get(name)))
        approach_times[label] += stage_done(timer, t0)

    # --- stage 9: progressive SR restore -------------------------------------
    levels_dec = _load_maps(down_maps_path)
    for i, name in enumerate(config.sr_backends):
        label = APPROACHES.PRESLEY_REALESRGAN if i == 0 else f"PRESLEY SR {name}"
        timer = "RealESRGAN Restoration" if i == 0 else f"SR {name} Restoration"
        fn, prov = resolve_sr_backend(name, config, device=dev)
        backend_provenance[label] = prov
        row_branch[label] = "downsampled"
        t0 = time.time()

        def _run_sr(fn=fn, name=name):
            sr_out = _restore_framewise(_per_device(resolve_sr_backend, name, fn), down_decoded,
                                        levels_dec, devices=config.realesrgan_devices)
            if config.temporal_blend > 0:
                sr_out = dp.apply_temporal(
                    as_pixels_u8(lambda f: temporal_blend(f, config.temporal_blend)),
                    (sr_out,), overlap=8)
            return sr_out

        decoded[label] = _cached_restore(f"sr_{name}", prov, _run_sr)
        approach_times[label] += stage_done(timer, t0)

    # --- stage 10: deblur restore ----------------------------------------------
    blur_levels_dec = _load_maps(blur_maps_path)
    for i, name in enumerate(config.deblur_backends):
        label = APPROACHES.PRESLEY_INSTANTIR if i == 0 else f"PRESLEY Deblur {name}"
        timer = "InstantIR Restoration" if i == 0 else f"Deblur {name} Restoration"
        fn, prov = resolve_deblur_backend(name, config, device=dev)
        backend_provenance[label] = prov
        row_branch[label] = "gaussian"
        t0 = time.time()

        def _run_deblur(fn=fn, name=name):
            deblurred = _restore_framewise(_per_device(resolve_deblur_backend, name, fn),
                                           blur_decoded, blur_levels_dec,
                                           devices=config.instantir_devices)
            if config.temporal_blend > 0:
                deblurred = dp.apply_temporal(
                    as_pixels_u8(lambda f: temporal_blend(f, config.temporal_blend)),
                    (deblurred,), overlap=8)
            return deblurred

        decoded[label] = _cached_restore(f"deblur_{name}", prov, _run_deblur)
        approach_times[label] += stage_done(timer, t0)

    # --- stage 11: bitrate accounting --------------------------------------------
    video_sizes = {
        APPROACHES.BASELINE: len(streams["baseline"]),
        APPROACHES.ELVIS: len(streams["shrunk"]) + os.path.getsize(masks_npz),
        APPROACHES.PRESLEY_QP: len(streams["roi"]),
        APPROACHES.PRESLEY_REALESRGAN: len(streams["downsampled"]) + sidecar_sizes["downsample"],
        APPROACHES.PRESLEY_INSTANTIR: len(streams["gaussian"]) + sidecar_sizes["gaussian"],
    }
    if config.enable_dct_dampen:
        video_sizes[APPROACHES.ELVIS_V2_DAMPEN] = (len(streams["dampened"])
                                                   + sidecar_sizes["dampen"])
    bitrates = {k: size * 8 / duration for k, size in video_sizes.items()}
    _branch_sizes = {
        "shrunk": video_sizes[APPROACHES.ELVIS],
        "downsampled": video_sizes[APPROACHES.PRESLEY_REALESRGAN],
        "gaussian": video_sizes[APPROACHES.PRESLEY_INSTANTIR],
    }
    for label, branch in row_branch.items():
        bitrates[label] = _branch_sizes[branch] * 8 / duration

    # --- stage 12: classical benchmarks ------------------------------------------
    if config.generate_opencv_benchmarks:
        t0 = time.time()
        decoded[APPROACHES.PRESLEY_LANCZOS] = dp.apply(
            as_pixels_u8(lambda f, m: restore_downsample_lanczos(f, m, b)),
            down_decoded, levels_dec)
        bitrates[APPROACHES.PRESLEY_LANCZOS] = bitrates[APPROACHES.PRESLEY_REALESRGAN]
        decoded[APPROACHES.PRESLEY_UNSHARP] = dp.apply(
            as_pixels_u8(lambda f, m: restore_blur_unsharp(f, m, b, config.gaussian_max_rounds)),
            blur_decoded, blur_levels_dec)
        bitrates[APPROACHES.PRESLEY_UNSHARP] = bitrates[APPROACHES.PRESLEY_INSTANTIR]
        stage_done("OpenCV Benchmarks", t0)

    # --- stage 13: evaluation ---------------------------------------------------
    t0 = time.time()
    analysis_results = analyze_encoding_performance(
        frames,
        decoded,
        fg_masks_pixel,
        bitrates,
        framerate=framerate,
        metric_stride=config.metric_stride,
        enable_fvmd=config.enable_fvmd,
        fvmd_stride=config.fvmd_stride,
        fvmd_early_stop_delta=config.fvmd_early_stop_delta,
        fvmd_early_stop_window=config.fvmd_early_stop_window,
        fvmd_max_frames=config.fvmd_max_frames,
        enable_vmaf=config.enable_vmaf,
        vmaf_stride=config.vmaf_stride,
        analysis_sample_frames=config.analysis_sample_frames,
        verbose=config.verbose,
        consume=True,  # each decoded clip's last use: free as evaluated
    )
    stage_done("Performance Evaluation", t0)
    if stats is not None:
        stats["stage_peak_bytes"] = dict(execution_times.peak_bytes)
        stats["streams"] = dict(streams)
    for approach, total in approach_times.items():
        execution_times[approach] = total

    # --- result assembly (the reference's schema) ----------------------------------
    analysis_results["execution_times_seconds"] = execution_times
    analysis_results["stage_cache"] = {"hits": list(cache.hits), "misses": list(cache.misses)}
    analysis_results["stage_rss_gb"] = dict(execution_times.rss_gb)
    analysis_results["video_name"] = config.reference_video
    analysis_results["video_length_seconds"] = duration
    analysis_results["video_framerate"] = framerate
    analysis_results["video_resolution"] = f"{width}x{height}"
    analysis_results["block_size"] = b
    analysis_results["target_bitrate_bps"] = target_bitrate
    analysis_results["parameters"] = {
        "config": config.to_dict(),
        "derived": {
            "framerate": framerate,
            "target_bitrate": target_bitrate,
            "experiment_dir": experiment_dir,
            "quality_factor": config.quality_factor,
            "codec": codec.name,
            "backends": backend_provenance,
        },
    }
    results_json_path = os.path.join(experiment_dir, "analysis_results.json")
    analysis_results["experiment_dir"] = experiment_dir
    analysis_results["analysis_results_path"] = results_json_path
    analysis_results["total_pipeline_seconds"] = time.time() - t_pipeline

    with open(results_json_path, "w") as f:
        json.dump(analysis_results, f, indent=4, default=float)

    print(format_summary_report(analysis_results))
    print(f"Analysis results saved to: {results_json_path}")
    return analysis_results
