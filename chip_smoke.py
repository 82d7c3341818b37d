#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any fault exits non-zero and prints no
``ok`` line):

  1. device: name, count, and ``nvidia-smi``'s name and power limit;
  2. build the hand-written CUDA kernels from ``elvis_tpu_torch/kernels/csrc``
     (one ``nvcc`` per source, started together) and hold each against the
     plain PyTorch version and against the other on the card, at the two
     paths' shapes and tables, timed with CUDA events against the
     function's memory/compute bound; levels outside the table too. The
     transform kernel is held in both of its layouts: float32 blocks, and
     frames as they lie in memory (uint8 and float32, with and without the
     unsharp epilogue) against the plain composition of split, transform,
     combine, round and clip;
  2b. the SR nets' conv epilogue kernel (``csrc/conv_epilogue.cu``; no TPU
     kernel) at the nets' trunk conv outputs on 8 x 540 x 960: the
     student's convs (256 channels bf16: bias and leaky ReLU) and its ``up``
     (12: bias alone, the kernel's channel-wrapping form), RRDB's ``fuse``
     (128: bias and two residuals) and its ``up`` (512: bias and leaky
     ReLU), held bit-equal to the plain version, timed
     beside its byte bound and beside PyTorch's own route (the cuDNN path's
     ``add_`` of the bias over the channels-last NCHW view, then each op
     as its own pass; never called by the port); ptxas registers and spills;
  3. the main path at full width: bench.py's 8-frame 1080p moving-gradient
     clip (plus seeded noise) -> complexity + motion-contrast saliency ->
     removability scores -> ``adaptive_downsample`` (through the kernel) ->
     ``resolve_sr_backend("realesrgan")`` (the committed ``srnet_student``,
     256 ch x 6 convs) -> ``progressive_restore`` -> masked PSNR / SSIM;
     then the same slice on a small crop on the card and on the CPU, held
     to each other;
  4. the blur path and the classical rows at full width, on the same clip
     and scores: ``adaptive_blur`` -> ``resolve_deblur_backend`` ('deblur_net'
     = the committed DeblurUNet, and 'unsharp'), and
     ``restore_downsample_lanczos`` on the main path's degraded frames ->
     masked PSNR / SSIM of each row; then the batched-small kernel on the
     path's own blocks and maps, held to the plain version and to what the
     path produced through the first kernel; then the blur slice on a small
     crop on the card and on the CPU.

  5. the main path through the NVC codec at full width, as the pipeline's
     downsample branch runs it: scores -> ``adaptive_downsample`` (the
     transform kernel) -> ``make_pipeline_codec("nvc")`` ``.encode`` at the
     target bitrate (two-pass rate targeting, gop 30) -> ``.decode`` -> the
     strength maps through the npz and the video sidecar and back ->
     ``progressive_restore`` with the maps read back -> masked PSNR / SSIM
     and the row's bits; the baseline row (the original clip at the same
     target); one encode and decode at fixed QP timed stage by stage (device
     half by CUDA events, host half by the host's clock, intra and P frames
     apart) and the hot spots of the device half each alone; then the
     codec's checks: the range coder built here wrote every section, the
     bit model and the Qstep table are the same numbers on the card and on
     the CPU, an encode repeats byte for byte, the chunked encode equals the
     single loop, and a crop's streams decode on the card and on the CPU
     within 1 LSB.

  6. the pipeline as users start it: ``run_elvis`` (what ``python -m
     elvis_tpu_torch.cli`` runs) on an 8-frame 1080p synthetic clip with the
     default config: scoring, the baseline, shrink (removal + motion hint),
     ROI, downsample and blur encodes, the stretch and the three fills (PDE,
     temporal propagation, InpaintNet over a temporal seed, the last two
     reading the motion hint), SR and deblur restores, the classical rows,
     evaluation with LPIPS and FVMD, analysis_results.json: nine rows. It
     prints the stage times, each row's QP, bytes, bit/s and metrics and
     the peak memory, checks the rows, the JSON and the sidecars, counts one
     transform launch per degrade or classical stage, runs again on the same
     directory (every encode and restore from the stage cache, the same
     rows), and holds a 6-frame 96x64 run on the card to one on the CPU;
  7. the two new fills alone at full width on the shrunk branch's decoded
     frames, as stage 8 calls them, CUDA events and peak memory each: the
     temporal fill with and without the motion hint, the E2FGVI seed, and
     the net's ``post`` as the stage drives it (height tiles) and in one
     call; then, on a centre crop, the temporal fill (with and without the
     hint) and the net on the card held to the same calls on the CPU;
  8. ``run_elvis`` at the same size with every remaining SR, deblur and
     saliency name whose weights ship (``srnet_large``, ``srnet_4k``,
     ``lanczos``, ``hybrid``, ``level_seq``, ``naive_sr``; ``diffusion``,
     ``naive_diffusion``; ``saliency_backend="neural"``) and the DCT-dampen
     branch, eighteen rows: stage times, peak memory by stage, the wall, no
     out-of-memory fallback, six transform launches; then the diffusion
     restore, the saliency net, ``dct_dampen`` and its inverse, the
     ``srnet_large`` tier, ``level_seq`` and ``naive_sr`` each alone (CUDA
     events, peak memory), and on a centre crop each held to the CPU;
  9. the SR tiers of RRDB ``SRNet`` and the external encoders:
     ``run_elvis`` at the same size through ``codec="x265"`` (preset
     'slow') with ``sr_backends=["realesrgan", "srnet", "srnet_ensemble"]``,
     eleven rows. No encoder binary exists on the card's machine (the phase
     prints ``which`` of them), so the phase sets ``ELVIS_TPU_FAKE_CODECS``
     itself and unsets it when done: the argv chain (5 encodes x 2 passes,
     the qpfile with ``ctu=16`` on the ROI encode's pass 2) and the qpfile
     (8 lines of 68x120 CTUs; its regrid on the card against the CPU) are
     checked, the rows' bits are the stash's size. Then kvazaar and SVT-AV1
     through their pipeline codecs on the clip, the QP / CRF from the rate
     model's probe on the card, each ROI file at 1080p held to the CPU; the
     RRDB tier and the ensemble alone (CUDA events, peak memory), and on a
     centre crop held to the CPU;
 10. the PRESLEY sweep as users start it: ``run_presley`` at
     ``PresleyConfig()``'s defaults (1280x720, 20 frames, block 16, both
     shrink methods: seventeen rows), every row ``ok`` with finite metrics,
     the JSON written, each row's time and the seven transform launches;
     then a 6x96x64 run on the card held to one on the CPU;
 11. the parallel layer on logical shards of the one card (the port's
     device list replaced by k copies of cuda:0): the ``srnet_student``
     restore of 4 frames of 2160p in height tiles (data 1 x spatial 3,
     ``spatial_tile_map_blocks``, halo 64; halo 32's error printed beside)
     against the whole frames; the temporal fill with halo frames
     (``temporal_map_overlap``, window 1, with and without the motion hint,
     the hint's field with its zero-motion halo edge) over 2 and 4 shards
     against one call; ``run_elvis`` with the default
     config over a 2-shard data mesh (rows against phase 6's, six transform
     launches); ``run_elvis`` with ``realesrgan_devices=[0]`` and
     ``spatial_devices=2`` (no mesh on one card: phase 6's rows, four
     launches); CUDA-event times and peak memory of each;
 12. training: ``train_srnet_student`` at the shipped architecture (256 x 6,
     batch 16, patch 64, the three teachers, procedural data) for 100 steps
     at lr 1e-3: ms a step by CUDA events, peak memory, the loss curve, the
     held-out loss after warm-up and at the end (it must fall), one
     transform launch a step; the checkpoint through ``resolve_sr_backend``
     with ``srnet_params_path`` (the tier named, the restore the trained
     module's); two steps on logical data 2 and data 2 x tensor 2 meshes
     against one device; two steps on the card against the CPU on a crop;
     ``deblur`` at its defaults and ``srnet_4k``, 5 steps each. The sharded
     comparison runs with deterministic cuDNN;
 13. the rest: ``rd_sweep`` on the 8-frame 1080p clip at QPs 26, 38 and 51
     (one point a QP, more bits more PSNR); ``grid_search`` and
     ``random_search`` over two default runs at 640x360, each run's rows
     held to a direct ``run_elvis`` of its overrides, then
     ``cleanup_results`` (the figures are skipped where matplotlib is
     missing, as in the JAX package); the diffusion, inpaint, saliency and
     perceptual trainers at their defaults, 5 steps each (step ms, peak
     memory, losses; each checkpoint through its loader, its forward the
     trained module's; one transform launch a diffusion step);
     ``sr_holdout_eval`` with the shipped ``srnet_student`` and
     ``deblur_holdout_eval`` with the shipped deblur net at 4 frames of 256
     px (the photo family drops out without PIL, and the output says so);
     ``graft_entry.entry()`` and ``dryrun_multichip(2)`` on logical shards
     of the card. Each part prints its ms, peak and transform launches.

``python3 chip_smoke.py --codec-only`` runs phase 5 alone (no kernel table,
no ``ok`` line). ``python3 chip_smoke.py --profile`` adds, before phase 5, a
``torch.profiler`` breakdown of one steady call of the two neural
restorers (device time by kernel name, device busy share) and of each of
the four transform stages, where it checks that no full-clip pass runs
beside the transform kernel; and, in phase 5, of the codec's four hot spots
(launch count and device busy share of each).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SEED = 0
N, H, W, B = 8, 1080, 1920, 8


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, iters, warmup=2):
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi_line)
    return name, count, smi_line


def block_transform_bound_ms(m, b, c, levels, in_size=4, out_size=4):
    """Least time for T[idx] X T[idx]^T on m blocks, whichever kernel and
    layout: read the elements (``in_size`` bytes each), idx and table once,
    write the output (``out_size`` bytes an element) once; 4 b^3 FLOPs per
    block and channel (two b x b products) at the FP32 rate."""
    nbytes = m * b * b * c * (in_size + out_size) + m * 4 + levels * b * b * 4
    flops = 4 * b**3 * m * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


KERNELS = {  # name -> (wrapper, source, TPU kernel replaced)
    "block_transform": ("block_transform.apply_block_matrix_cuda",
                        "elvis_tpu_torch/kernels/csrc/block_transform.cu",
                        "elvis_tpu/kernels/block_transform.py:241"),
    "block_transform_batched": ("block_transform.apply_block_matrix_batched_cuda",
                                "elvis_tpu_torch/kernels/csrc/block_transform_batched.cu",
                                "elvis_tpu/kernels/block_transform.py:119"),
    "conv_epilogue": ("conv_epilogue.conv_epilogue_cuda",
                      "elvis_tpu_torch/kernels/csrc/conv_epilogue.cu",
                      "none: XLA fuses the flax convs' bias, activation and residuals"),
}
BLOCK_KERNELS = ("block_transform", "block_transform_batched")  # phase 2's pair
STUDENT_TRUNK_CONVS = 8  # srnet_student: head, six convs, up; each one conv_epilogue launch
KERNEL_TOL = 1e-3
U8_SHARE_TOL = 1e-3  # share of uint8 pixels that may differ (by 1 LSB) from the plain version


def ptxas_summary(log):
    """Kernels, registers and spills of one nvcc run's ptxas report."""
    regs = [int(w.split()[0]) for w in log.split("Used")[1:]]
    spills = [line.strip() for line in log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    return (f"{len(regs)} kernel(s), registers {min(regs)}-{max(regs)}, "
            f"{len(spills)} with spills" + (f": {spills[:3]}" if spills else ""))


def plain_frames(bt, frames, t, levels, b, amount=None, transform=None):
    """The plain composition the frame layout replaces: cast, split into
    blocks, transform (einsums; or ``transform(blocks, levels)``), the
    unsharp combine, put together, round and clip, cast back. ``t`` and
    ``amount`` are device tensors."""
    from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks

    x = split_into_blocks(frames, b).float()
    out = bt.apply_block_matrix(x, t, levels) if transform is None else transform(x, levels)
    if amount is not None:
        a = amount[levels.long()][..., None, None, None]
        out = torch.where(a > 0, torch.clamp((1.0 + a) * x - a * out, 0, 255), x)
    out = combine_blocks(out)
    if frames.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)


def bmm_route(t, x, idx):
    """The batched kernel's library route: each block's T gathered
    (a negative level wraps once, the rest is clamped), then two
    ``torch.bmm`` in float32 without TF32, ``T X`` and ``(T X) T^T``.
    Blocks ``(M, b, b, C)`` float32 -> a new ``(M, b, b, C)``."""
    from elvis_tpu_torch.device import full_fp32

    m, b, _, c = x.shape
    ell = t.shape[0]
    lv = idx.long()
    tm = t[torch.where(lv < 0, lv + ell, lv).clamp(0, ell - 1)]  # (M, b, b)
    with full_fp32():
        y = torch.bmm(tm, x.reshape(m, b, b * c))  # T X
        y = y.view(m, b, b, c).permute(0, 3, 1, 2).reshape(m, c * b, b)  # rows (c, i)
        z = torch.bmm(y, tm.transpose(1, 2))  # (T X) T^T
    return z.view(m, c, b, b).permute(0, 2, 3, 1).contiguous()


def held_u8(got, want):
    """Two uint8 tensors apart: the largest distance in LSB, the pixels that
    differ, and their share."""
    diff = (got.int() - want.int()).abs()
    err, differing = float(diff.max().item()), int((diff > 0).sum().item())
    return err, differing, differing / diff.numel()


def phase_frame_layout(bt, gen):
    """The transform kernel on frames: each row held to the plain
    composition and timed against the bound of the function in these
    types, beside its library route (the same composition around
    ``apply_block_matrix_kron``: one cuBLAS product and a gather). Returns
    the rows, the main path's (uint8, b=8, resample) first."""
    from elvis_tpu_torch.restore.unsharp import _unsharp_blur_table

    dev = torch.device("cuda")
    u8, f32 = torch.uint8, torch.float32
    rows = [  # (label, dtype, b, table, with the unsharp epilogue)
        ("frames_u8_b8_L4_resample_linear", u8, 8, bt.resample_matrix_table(8, "linear"), False),
        ("frames_u8_b8_L11_blur", u8, 8, bt.blur_matrix_table(8, 10), False),
        ("frames_u8_b8_L11_unsharp", u8, 8, _unsharp_blur_table(8, 10), False),
        ("frames_u8_b8_L4_lanczos4", u8, 8, bt.resample_matrix_table(8, "lanczos4"), False),
        ("frames_u8_b8_L11_unsharp_epilogue", u8, 8, _unsharp_blur_table(8, 10), True),
        ("frames_u8_b16_L5_resample_linear", u8, 16, bt.resample_matrix_table(16, "linear"),
         False),
        ("frames_f32_b8_L4_resample_linear", f32, 8, bt.resample_matrix_table(8, "linear"),
         False),
        ("frames_f32_b8_L11_unsharp_epilogue", f32, 8, _unsharp_blur_table(8, 10), True),
    ]
    h = H - H % 16  # 1072 rows: whole blocks at b=16 too
    results = []
    for label, dtype, b, table, epilogue in rows:
        ell = table.shape[0]
        hh = h if b == 16 else H
        frames = torch.randint(0, 256, (N, hh, W, 3), generator=gen, device=dev, dtype=u8)
        if dtype == f32:
            frames = frames.float() + torch.rand(frames.shape, generator=gen, device=dev)
        levels = torch.randint(0, ell, (N, hh // b, W // b), generator=gen, device=dev,
                               dtype=torch.int32)
        t = bt.device_table(table, dev)
        amount = (0.5 * torch.arange(ell, device=dev, dtype=f32)) if epilogue else None

        def kernel():
            return bt.apply_table_to_frames_cuda(frames, t, levels, b, amount=amount)

        def library():
            return plain_frames(bt, frames, None, levels, b, amount,
                                lambda x, lv: bt.apply_block_matrix_kron(x, table, lv))

        got = kernel()
        torch.cuda.synchronize()
        want = plain_frames(bt, frames, t, levels, b, amount)
        check(got.dtype == dtype and got.shape == frames.shape, f"{label}: output type or shape")
        lib = library()
        check(lib.dtype == dtype and lib.shape == frames.shape,
              f"{label}: library route's type or shape")
        if dtype == u8:
            err, differing, share = held_u8(got, want)
            check(err <= 1 and share <= U8_SHARE_TOL,
                  f"{label}: {err} LSB on {differing} pixels ({share:.2e}) vs the plain version")
            held = f"max {err:.0f} LSB on {differing} of {want.numel()} pixels (tol 1 LSB)"
            lib_err, lib_differing, lib_share = held_u8(lib, want)
            check(lib_err <= 1 and lib_share <= U8_SHARE_TOL,
                  f"{label}: the library route is {lib_err} LSB on {lib_differing} pixels "
                  f"({lib_share:.2e}) from the plain version")
            lib_held = f"max {lib_err:.0f} LSB on {lib_differing} pixels"
        else:
            err, differing = (got - want).abs().max().item(), None
            check(math.isfinite(err) and err <= KERNEL_TOL,
                  f"{label}: max |kernel - plain| = {err} > {KERNEL_TOL}")
            held = f"max_abs_err {err:.3g} (tol {KERNEL_TOL})"
            lib_err = (lib - want).abs().max().item()
            check(math.isfinite(lib_err) and lib_err <= KERNEL_TOL,
                  f"{label}: max |library route - plain| = {lib_err} > {KERNEL_TOL}")
            lib_held = f"max_abs_err {lib_err:.3g}"
        del lib
        if epilogue:  # blocks with amount 0 come back bit-exact
            keep = (levels == 0).repeat_interleave(b, -1).repeat_interleave(b, -2)[..., None]
            check(torch.equal(torch.where(keep, got, 0), torch.where(keep, frames, 0)),
                  f"{label}: a level-0 block changed under the unsharp epilogue")
        del got, want
        runs = {"kernel": [], "library": []}
        for route in ("kernel", "library", "library", "kernel"):
            runs[route].append(cuda_ms(kernel if route == "kernel" else library, iters=50))
        plain_ms = cuda_ms(lambda: plain_frames(bt, frames, t, levels, b, amount), iters=3,
                           warmup=1)
        size = frames.element_size()
        m = levels.numel()
        bound, by = block_transform_bound_ms(m, b, 3, ell, size, size)
        ms, lib_ms = (sum(runs[r]) / len(runs[r]) for r in ("kernel", "library"))
        print(f"[kernel] block_transform {label} {N}x{hh}x{W}x3: {held}, kernel {ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['kernel'])}), library route "
              f"(apply_block_matrix_kron composition; {lib_held}) {lib_ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['library'])}), plain composition "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
        results.append({"label": label, "max_abs_err": err, "uint8_pixels_differing": differing,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib_ms, "library_max_abs_err": lib_err})
        del frames, levels

    # levels outside [0, L) in frame layout: wrap once, then clamp
    table = bt.blur_matrix_table(8, 10)
    ell = table.shape[0]
    t = bt.device_table(table, dev)
    odd = torch.tensor([-1, -ell - 1, ell, ell + 5], dtype=torch.int32, device=dev)
    rule = torch.tensor([ell - 1, 0, ell - 1, ell - 1], dtype=torch.int32, device=dev)
    frames = torch.randint(0, 256, (4, 64, 200, 3), generator=gen, device=dev, dtype=u8)
    shape = (4, 8, 25)
    got = bt.apply_table_to_frames_cuda(frames, t, odd.repeat(200).view(shape), 8)
    check(torch.equal(got, bt.apply_table_to_frames_cuda(frames, t, rule.repeat(200).view(shape),
                                                         8)),
          "frame layout: out-of-range levels do not wrap once and clamp")
    diff = (got.int() - plain_frames(bt, frames, t, odd.repeat(200).view(shape), 8).int()).abs()
    check(diff.max().item() <= 1, f"frame layout, out-of-range levels: {diff.max().item()} LSB")
    print(f"[kernel] block_transform frames (W*C = 600 bytes: the scalar path) levels "
          f"{{-1, -L-1, L, L+5}}: max {diff.max().item()} LSB (tol 1 LSB)")
    return results



def phase_kernels():
    """Build both kernels; per shape, hold each to the plain version and to
    the other, and time them. Returns ``{kernel name: [result per shape]}``
    in block layout, the main path's table first, and the transform
    kernel's rows in frame layout."""
    from elvis_tpu_torch.kernels import _build
    from elvis_tpu_torch.kernels import block_transform as bt
    from elvis_tpu_torch.restore.unsharp import _unsharp_blur_table

    t0 = time.time()
    times = _build.build_all()
    print(f"[build] {len(times)} source(s) compiled in {time.time() - t0:.1f} s: "
          f"{json.dumps({k: round(v, 1) for k, v in times.items()})}")
    check(set(_build.SOURCES) == set(KERNELS), f"sources {sorted(_build.SOURCES)}, expected "
                                               f"{sorted(KERNELS)}")
    found = [n for n in KERNELS if n not in times]  # built by an earlier run of this checkout
    if found:
        print(f"[build] already built from these sources: {found}")
    check(all(_build._lib_path(n).is_file() for n in KERNELS), "a kernel library is missing")
    for name, log in _build.BUILD_LOGS.items():
        print(f"[ptxas] {name}: {ptxas_summary(log)}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fns = {name: getattr(bt, KERNELS[name][0].split(".")[1]) for name in BLOCK_KERNELS}
    m8, m16 = N * (H // 8) * (W // 8), N * (H // 16) * (W // 16)
    both = BLOCK_KERNELS
    shapes = [  # (label, b, table, M, C, kernels): the main path's table first
        ("b8_L4_resample_linear", 8, bt.resample_matrix_table(8, "linear"), m8, 3, both),
        ("b8_L11_blur", 8, bt.blur_matrix_table(8, 10), m8, 3, both),
        ("b8_L11_unsharp", 8, _unsharp_blur_table(8, 10), m8, 3, both),
        ("b8_L4_lanczos4", 8, bt.resample_matrix_table(8, "lanczos4"), m8, 3, both),
        ("b16_L5_resample_linear", 16, bt.resample_matrix_table(16, "linear"), m16, 3, both),
        ("b16_L5_resample_linear_C1", 16, bt.resample_matrix_table(16, "linear"), m16, 1,
         ("block_transform_batched",)),
    ]
    # each kernel's library route, in the kernels' (M, b, b, C) layout: the
    # dense product over every level and a gather (the JAX package's
    # apply_block_matrix_kron), or T gathered per block and two batched
    # products
    routes = {"block_transform":
              lambda table, t, x, i: bt.apply_block_matrix_kron(x, table, i).contiguous(),
              "block_transform_batched": lambda table, t, x, i: bmm_route(t, x, i)}
    results = {name: [] for name in BLOCK_KERNELS}
    for label, b, table, m, c, names in shapes:
        ell = table.shape[0]
        x = torch.rand((m, b, b, c), generator=gen, device=dev) * 255
        idx = torch.randint(0, ell, (m,), generator=gen, device=dev, dtype=torch.int32)
        t = torch.as_tensor(table, dtype=torch.float32, device=dev)
        want = bt.apply_block_matrix(x, t, idx)
        got, errs, lib_errs = {}, {}, {}
        for name in names:
            got[name] = fns[name](x, t, idx)
            torch.cuda.synchronize()
            errs[name] = (got[name] - want).abs().max().item()
            check(math.isfinite(errs[name]) and errs[name] <= KERNEL_TOL,
                  f"{name} {label}: max |kernel - plain| = {errs[name]} > {KERNEL_TOL}")
            lib = routes[name](table, t, x, idx)
            check(lib.shape == want.shape and lib.dtype == torch.float32,
                  f"{name} {label}: library route's type or shape")
            lib_errs[name] = (lib - want).abs().max().item()
            check(math.isfinite(lib_errs[name]) and lib_errs[name] <= KERNEL_TOL,
                  f"{name} {label}: max |library route - plain| = {lib_errs[name]} > "
                  f"{KERNEL_TOL}")
            del lib
        if len(names) == 2:
            cross = (got[names[0]] - got[names[1]]).abs().max().item()
            check(cross <= KERNEL_TOL, f"{label}: the two kernels differ by {cross}")
            print(f"[kernel] {label}: max |block_transform - block_transform_batched| = "
                  f"{cross:.3g} (tol {KERNEL_TOL})")
        del got, want
        # the kernels and their library routes in turns (a, b, b, a), 50
        # launches each time
        calls = {name: (lambda name=name: fns[name](x, t, idx)) for name in names}
        calls.update({f"{name} library": (lambda name=name: routes[name](table, t, x, idx))
                      for name in names})
        order = list(calls) + list(reversed(calls))
        runs = {key: [] for key in calls}
        for key in order:
            runs[key].append(cuda_ms(calls[key], iters=50))
        plain_ms = cuda_ms(lambda: bt.apply_block_matrix(x, t, idx), iters=10)
        bound, by = block_transform_bound_ms(m, b, c, ell)
        for name in names:
            ms, lib_ms = (sum(runs[k]) / len(runs[k]) for k in (name, f"{name} library"))
            print(f"[kernel] {name} {label} M={m} C={c}: max_abs_err {errs[name]:.3g} "
                  f"(tol {KERNEL_TOL}), kernel {ms:.4f} ms "
                  f"({', '.join(f'{r:.4f}' for r in runs[name])}), library route "
                  f"({'apply_block_matrix_kron' if name == 'block_transform' else 'gather + 2 bmm'}"
                  f"; max_abs_err {lib_errs[name]:.3g}) {lib_ms:.4f} ms "
                  f"({', '.join(f'{r:.4f}' for r in runs[f'{name} library'])}), plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
            results[name].append({"label": label, "max_abs_err": errs[name], "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                                  "library_ms": lib_ms, "library_max_abs_err": lib_errs[name]})
        del x, idx

    # levels outside [0, L): a negative level wraps once, the rest is clamped
    table = bt.blur_matrix_table(8, 10)
    ell = table.shape[0]
    t = torch.as_tensor(table, dtype=torch.float32, device=dev)
    odd = torch.tensor([-1, -ell - 1, ell, ell + 5], dtype=torch.int32, device=dev).repeat(100)
    rule = torch.tensor([ell - 1, 0, ell - 1, ell - 1], dtype=torch.int32, device=dev).repeat(100)
    x = torch.rand((odd.numel(), 8, 8, 3), generator=gen, device=dev) * 255
    want = bt.apply_block_matrix(x, t, odd)
    check(torch.equal(want, bt.apply_block_matrix(x, t, rule)),
          "plain version: out-of-range levels do not wrap once and clamp")
    for name, fn in fns.items():
        err = (fn(x, t, odd) - want).abs().max().item()
        check(err <= KERNEL_TOL, f"{name}: out-of-range levels differ from the plain version "
                                 f"by {err}")
        print(f"[kernel] {name} levels {{-1, -L-1, L, L+5}}: max_abs_err {err:.3g} "
              f"(tol {KERNEL_TOL})")

    # the backward (same transform with T^T) goes through the first kernel too
    x = (torch.rand((2, 6, 5, 8, 8, 3), generator=gen, device=dev) * 255).requires_grad_(True)
    idx = torch.randint(0, 11, (2, 6, 5), generator=gen, device=dev, dtype=torch.int32)
    (bt.apply_block_matrix_fast(x, table, idx) ** 2).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    (bt.apply_block_matrix(xr, t, idx) ** 2).sum().backward()
    torch.cuda.synchronize()
    rel = ((x.grad - xr.grad).abs().max() / xr.grad.abs().max()).item()
    check(rel <= 1e-5, f"block_transform backward: relative error {rel} > 1e-5")
    print(f"[kernel] block_transform backward: max relative error {rel:.3g} (tol 1e-5)")
    del x, xr
    return results, phase_frame_layout(bt, gen)


EPILOGUE_ROWS = [  # (label, (N, H, W, C), slope, residual scale, outer scale)
    ("student_conv_bias_slope", (N, H // 2, W // 2, 256), 0.2, None, None),
    ("student_up_bias", (N, H // 2, W // 2, 12), None, None, None),
    ("rrdb_fuse_bias_two_residuals", (N, H // 2, W // 2, 128), None, 0.2, 0.2),
    ("rrdb_up_bias_slope", (N, H // 2, W // 2, 512), 0.2, None, None),
]


def library_epilogue(y, bias, slope, residual, scale, outer, outer_scale):
    """PyTorch's route for a conv output without its bias: the bias added in
    place over the channels-last NCHW view, as ``aten::_convolution`` does
    after cuDNN, then one pass per op."""
    y.permute(0, 3, 1, 2).add_(bias.reshape(1, -1, 1, 1))
    if slope is not None:
        y = torch.nn.functional.leaky_relu(y, slope)
    if residual is not None:
        y = residual + scale * y
    if outer is not None:
        y = outer + outer_scale * y
    return y


def phase_epilogue():
    """The conv epilogue kernel at the nets' shapes: bit-equal to the plain
    version, timed with CUDA events beside its byte bound, the plain version
    and PyTorch's own route (phase 2 built it). Returns the rows."""
    from elvis_tpu_torch.kernels import conv_epilogue as epi

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for label, shape, slope, scale, outer_scale in EPILOGUE_ROWS:
        def rand(*s):
            return (torch.randn(s, generator=gen, device=dev) * 2).to(torch.bfloat16)

        y0, bias = rand(*shape), rand(shape[-1])
        residual = rand(*shape) if scale is not None else None
        outer = rand(*shape) if outer_scale is not None else None
        ops = (slope, residual, 1.0 if scale is None else scale, outer,
               1.0 if outer_scale is None else outer_scale)
        want = epi.conv_epilogue(y0, bias, *ops)
        lib = library_epilogue(y0.clone(), bias, *ops)
        y = y0.clone()
        got = epi.conv_epilogue_cuda(y, bias, *ops)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"conv_epilogue {label}: kernel and plain version differ "
                                      f"by {(got.float() - want.float()).abs().max().item()}")
        check(torch.equal(lib, want), f"conv_epilogue {label}: PyTorch's route differs from "
                                      "the plain version")
        del want, lib, got
        # in place: each timed call rewrites y (the values do not matter to the time)
        calls = {"kernel": lambda: epi.conv_epilogue_cuda(y, bias, *ops),
                 "library": lambda: library_epilogue(y, bias, *ops)}
        runs = {k: [] for k in calls}
        for key in list(calls) + list(reversed(calls)):
            runs[key].append(cuda_ms(calls[key], iters=20))
        plain_ms = cuda_ms(lambda: epi.conv_epilogue(y0, bias, *ops), iters=10)
        n = y0.numel()
        nbytes = 2 * n * (2 + (residual is not None) + (outer is not None)) + 2 * shape[-1]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms, lib_ms = (sum(runs[k]) / len(runs[k]) for k in ("kernel", "library"))
        print(f"[epilogue] {label} {shape}: bit-equal to the plain version; kernel {ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['kernel'])}), PyTorch's route "
              f"{lib_ms:.4f} ms ({', '.join(f'{r:.4f}' for r in runs['library'])}), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes: {nbytes:,} B), "
              f"{bound / ms:.1%} of bound")
        rows.append({"label": label, "shape": list(shape), "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lib_ms})
        del y0, y, bias, residual, outer
    print(json.dumps({"epilogue": rows}))
    return rows


def make_clip(device):
    """bench.py's structured 1080p clip (moving gradients), grey in RGB,
    plus N(0, 2) noise from a seeded generator; uint8 (N, H, W, 3)."""
    t = torch.arange(N, device=device, dtype=torch.float32)[:, None, None]
    yy = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    clip = torch.clamp(128 + 80 * torch.sin(2 * math.pi * (xx + 40 * t) / 300)
                       * torch.cos(2 * math.pi * yy / 200), 0, 255)
    rgb = clip[..., None].expand(N, H, W, 3)
    gen = torch.Generator(device=device).manual_seed(SEED)
    noise = torch.randn((N, H, W, 3), generator=gen, device=device) * 2.0
    return torch.clamp(torch.round(rgb + noise), 0, 255).to(torch.uint8)


def score(frames, cfg):
    from elvis_tpu_torch.scoring import (get_saliency_fn, removability_scores,
                                         saliency_to_block_mask, spatial_temporal_complexity)

    cx = spatial_temporal_complexity(frames, cfg.block_size)
    sal = get_saliency_fn(cfg.saliency_backend)(frames)
    scores = removability_scores(cx.SC, cx.TC, saliency_to_block_mask(sal, cfg.block_size),
                                 alpha=cfg.removability_alpha,
                                 smoothing_beta=cfg.removability_smoothing_beta)
    return scores, sal >= 0.5


def phase_main_path():
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.kernels.block_transform import TABLE_UPLOADS
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.utils.trace import counter

    nets = counter("nets")
    dev = torch.device("cuda")
    cfg = ElvisConfig()
    check(cfg.block_size == B, "default block size changed")
    frames = make_clip(dev)
    restore, prov = resolve_sr_backend(cfg.sr_backends[0], cfg, device=dev)
    print(f"[main] backend {cfg.sr_backends[0]!r} -> {prov}")
    check(prov.startswith("progressive_neural[srnet_student:"),
          f"realesrgan did not resolve to the committed srnet_student: {prov}")
    lanczos, _ = resolve_sr_backend("progressive_lanczos", cfg, device=dev)

    stages = ["scoring", "adaptive_downsample", "progressive_restore", "metrics"]

    def run_path():
        """One pass of the main path; returns its outputs and per-stage ms."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        scores, fg = score(frames, cfg)
        ev[1].record()
        degraded, levels = adaptive_downsample(frames, scores, B)
        ev[2].record()
        restored = restore(degraded, levels, B)
        ev[3].record()
        metrics = (masked_psnr(frames, degraded), masked_psnr(frames, restored),
                   masked_psnr(frames, restored, fg), masked_ssim(frames, restored))
        ev[4].record()
        torch.cuda.synchronize()
        ms = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(stages)}
        return degraded, levels, restored, metrics, ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    nets.clear()
    degraded, levels, restored, metrics, first_ms = run_path()
    launches, net_convs = dict(LAUNCHES), dict(nets)
    peak = torch.cuda.max_memory_allocated()
    psnr_dec, psnr_res, psnr_res_fg, ssim_res = metrics
    check(launches.get("block_transform", 0) == 1,
          f"the main path launches block_transform once (adaptive_downsample): {launches}")
    print(f"[main] kernel launches on the main path: {json.dumps(launches)}")
    print(f"[main] first pass per stage (ms, CUDA events, includes cuDNN warm-up): "
          f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")
    uploads = sum(TABLE_UPLOADS.values())
    steady = [run_path()[-1] for _ in range(3)]
    check(sum(TABLE_UPLOADS.values()) == uploads,
          "a steady pass of the main path uploaded a table again")
    phase_ms = {n: sum(s[n] for s in steady) / len(steady) for n in stages}
    total_ms = sum(phase_ms.values())
    print(f"[main] steady pass per stage (ms, mean of 3, CUDA events): "
          f"{json.dumps({k: round(v, 3) for k, v in phase_ms.items()})}; total "
          f"{total_ms:.3f} ms = {N / (total_ms / 1e3):.2f} frames/s end to end")

    check(restored.shape == frames.shape and restored.dtype == torch.uint8,
          f"restored {tuple(restored.shape)} {restored.dtype}")
    check(degraded.shape == frames.shape and degraded.dtype == torch.uint8, "degraded shape")
    lv_hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    max_level = int(levels.max())
    print(f"[main] level histogram (levels 0..3): {lv_hist}; max level {max_level}")
    check(max_level >= 1, "no block was downsampled")
    # one student call per stage of the progressive restore, each trunk conv
    # fused into one conv_epilogue launch
    want = STUDENT_TRUNK_CONVS * max_level
    check(launches.get("conv_epilogue", 0) == want
          and net_convs == {"epilogue.fused": want},
          f"the restore launches conv_epilogue {want} times ({STUDENT_TRUNK_CONVS} trunk convs "
          f"x {max_level} stages), every trunk conv fused: {launches}, nets {net_convs}")
    for name, v in (("psnr_degraded", psnr_dec), ("psnr_restored", psnr_res),
                    ("psnr_restored_fg", psnr_res_fg), ("ssim_restored", ssim_res)):
        check(bool(torch.isfinite(v).all()), f"{name} not finite: {v.tolist()}")

    # restore throughput: the client's work per clip, repeated
    restore_ms = cuda_ms(lambda: restore(degraded, levels, B), iters=3, warmup=1)
    lanczos_ms = cuda_ms(lambda: lanczos(degraded, levels, B), iters=3, warmup=1)
    restored_l = lanczos(degraded, levels, B)
    psnr_l = masked_psnr(frames, restored_l)
    torch.cuda.synchronize()
    summary = {
        "frames": N, "height": H, "width": W, "block": B,
        "restore_ms_per_clip": restore_ms, "restore_fps": N / (restore_ms / 1e3),
        "progressive_lanczos_ms_per_clip": lanczos_ms,
        "main_path_ms_per_clip": total_ms, "stage_ms": phase_ms,
        "psnr_degraded_db": psnr_dec.mean().item(),
        "psnr_restored_db": psnr_res.mean().item(),
        "psnr_restored_fg_db": psnr_res_fg.mean().item(),
        "psnr_progressive_lanczos_db": psnr_l.mean().item(),
        "ssim_restored": ssim_res.mean().item(),
        "max_memory_allocated_bytes": peak,
        "provenance": prov,
    }
    print(f"[main] restore (srnet_student, progressive): {restore_ms:.3f} ms per "
          f"{N}-frame 1080p clip = {summary['restore_fps']:.2f} frames/s (CUDA events)")
    print(f"[main] PSNR degraded {summary['psnr_degraded_db']:.4f} dB, restored "
          f"{summary['psnr_restored_db']:.4f} dB (fg {summary['psnr_restored_fg_db']:.4f} dB), "
          f"progressive Lanczos {summary['psnr_progressive_lanczos_db']:.4f} dB; "
          f"SSIM restored {summary['ssim_restored']:.5f}")
    print(f"[main] max_memory_allocated {peak} bytes")
    print(f"[main] summary {json.dumps(summary)}")
    check(summary["psnr_restored_db"] > summary["psnr_degraded_db"] - 1.0,
          "restore made the clip much worse than the degraded frames")

    # reference on a small input: the same slice on the card and on the CPU
    crop = frames[:2, :64, :96].contiguous()
    s_gpu, _ = score(crop, cfg)
    s_cpu, _ = score(crop.cpu(), cfg)
    s_err = (s_gpu.cpu() - s_cpu).abs().max().item()
    check(s_err <= 1e-4, f"scores card vs CPU: {s_err}")
    cpu_restore, _ = resolve_sr_backend(cfg.sr_backends[0], cfg, device="cpu")
    d_gpu, l_gpu = adaptive_downsample(crop, s_gpu, B)
    d_cpu, l_cpu = adaptive_downsample(crop.cpu(), s_gpu.cpu(), B)
    check(torch.equal(l_gpu.cpu(), l_cpu), "level maps card vs CPU")
    d_err = (d_gpu.cpu().int() - d_cpu.int()).abs().max().item()
    check(d_err <= 1, f"degraded crop card vs CPU: {d_err} LSB")
    r_gpu = restore(d_gpu, l_gpu, B).cpu()
    r_cpu = cpu_restore(d_cpu, l_cpu, B)
    p_gpu = masked_psnr(crop.cpu(), r_gpu)
    p_cpu = masked_psnr(crop.cpu(), r_cpu)
    p_err = (p_gpu - p_cpu).abs().max().item()
    r_err = (r_gpu.int() - r_cpu.int()).abs().max().item()
    print(f"[reference] 2x64x96 crop, card vs CPU: scores {s_err:.3g}, degraded "
          f"{d_err} LSB, restored max {r_err} LSB, PSNR {p_err:.4f} dB (tol 0.05)")
    check(p_err <= 0.05, f"restored PSNR card vs CPU differs by {p_err} dB")
    scores, fg = score(frames, cfg)
    return launches, {"frames": frames, "scores": scores, "fg": fg, "degraded": degraded,
                      "levels": levels}


def phase_blur_path(main):
    """The blur branch and the classical rows on the main path's clip,
    scores and degraded frames. Returns the path's kernel launches."""
    from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
    from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.kernels import block_transform as bt
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore import restore_downsample_lanczos
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend
    from elvis_tpu_torch.restore.unsharp import _unsharp_blur_table

    dev = torch.device("cuda")
    cfg = ElvisConfig()
    frames, scores, fg = main["frames"], main["scores"], main["fg"]
    degraded, levels = main["degraded"], main["levels"]
    max_rounds = cfg.gaussian_max_rounds
    deblur, prov = resolve_deblur_backend(cfg.deblur_backends[0], cfg, device=dev)
    print(f"[blur] backend {cfg.deblur_backends[0]!r} -> {prov}")
    check(prov.startswith("deblur_net:") and prov.endswith("deblur.npz"),
          f"{cfg.deblur_backends[0]} did not resolve to the committed deblur net: {prov}")
    unsharp, prov_u = resolve_deblur_backend("unsharp", cfg, device=dev)
    check(prov_u == "unsharp", f"unsharp resolved to {prov_u}")

    stages = ["adaptive_blur", "deblur_net", "unsharp", "lanczos", "metrics"]
    rows = ("deblur_net", "unsharp", "lanczos")

    def run_path():
        """One pass of the blur path; returns its outputs and per-stage ms."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        count = [LAUNCHES["block_transform"]]
        ev[0].record()
        blurred, rounds = adaptive_blur(frames, scores, B, max_rounds)
        ev[1].record()
        count.append(LAUNCHES["block_transform"])
        out = {"deblur_net": deblur(blurred, rounds, B)}
        ev[2].record()
        count.append(LAUNCHES["block_transform"])
        out["unsharp"] = unsharp(blurred, rounds, B)
        ev[3].record()
        count.append(LAUNCHES["block_transform"])
        out["lanczos"] = restore_downsample_lanczos(degraded, levels, B)
        ev[4].record()
        count.append(LAUNCHES["block_transform"])
        per_stage = [b - a for a, b in zip(count, count[1:])]
        check(per_stage == [1, 0, 1, 1], "block_transform launches per stage of the blur path "
                                         f"(blur, net, unsharp, Lanczos): {per_stage}")
        metrics = {"blurred": (masked_psnr(frames, blurred), masked_psnr(frames, blurred, fg)),
                   "degraded": (masked_psnr(frames, degraded), masked_psnr(frames, degraded, fg))}
        for row in rows:
            metrics[row] = (masked_psnr(frames, out[row]), masked_psnr(frames, out[row], fg),
                            masked_ssim(frames, out[row]))
        ev[5].record()
        torch.cuda.synchronize()
        ms = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(stages)}
        return blurred, rounds, out, metrics, ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    blurred, rounds, out, metrics, first_ms = run_path()
    # the batched-small kernel on the path's own blocks and maps: what went
    # into the blur, the unsharp and the Lanczos transforms
    calls = {
        "blur": (frames, bt.blur_matrix_table(B, max_rounds), rounds),
        "unsharp": (blurred, _unsharp_blur_table(B, max_rounds), rounds),
        "lanczos": (degraded, bt.resample_matrix_table(B, "lanczos4"), levels),
    }
    batched = {}
    for label, (src, table, maps) in calls.items():
        x = split_into_blocks(src, B).float().reshape(-1, B, B, 3).contiguous()
        t = torch.as_tensor(table, dtype=torch.float32, device=dev)
        idx = maps.reshape(-1).to(torch.int32).contiguous()
        batched[label] = (x, t, idx, bt.apply_block_matrix_batched_cuda(x, t, idx))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[blur] kernel launches on the blur path: {json.dumps(launches)}")
    check(launches.get("block_transform", 0) == 3,
          f"the blur path launches block_transform three times, once per stage: {launches}")
    check(launches.get("block_transform_batched", 0) >= 3,
          f"the blur path launched block_transform_batched fewer than 3 times: {launches}")

    # hold the batched kernel to the plain version, and to what the path
    # produced through the first kernel (same rounding to uint8)
    def as_frames(z):
        z = combine_blocks(z.reshape(N, H // B, W // B, B, B, 3))
        return torch.clamp(torch.round(z), 0, 255).to(torch.uint8)

    for label, (x, t, idx, z) in batched.items():
        err = (z - bt.apply_block_matrix(x, t, idx)).abs().max().item()
        check(err <= KERNEL_TOL, f"batched kernel on the path's {label} blocks: {err}")
        if label == "unsharp":  # the affine combine of restore_blur_unsharp
            amount = (0.5 * idx.float())[:, None, None, None]
            z = torch.where(amount > 0, torch.clamp((1 + amount) * x - amount * z, 0, 255), x)
        path_out = {"blur": blurred, "unsharp": out["unsharp"], "lanczos": out["lanczos"]}[label]
        diff = (as_frames(z).int() - path_out.int()).abs()
        lsb, share = diff.max().item(), (diff > 0).float().mean().item()
        check(lsb <= 1 and share <= 1e-3,
              f"batched kernel vs the path's {label} output: {lsb} LSB on {share:.2%} of pixels")
        print(f"[blur] batched kernel on the path's {label} blocks: max_abs_err vs plain "
              f"{err:.3g} (tol {KERNEL_TOL}); vs the path's output {lsb} LSB, "
              f"{share:.2e} of pixels differ")
    del batched

    print(f"[blur] first pass per stage (ms, CUDA events, includes cuDNN warm-up): "
          f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")
    uploads = sum(bt.TABLE_UPLOADS.values())
    steady = [run_path()[-1] for _ in range(3)]
    check(sum(bt.TABLE_UPLOADS.values()) == uploads,
          "a steady pass of the blur path uploaded a table again")
    print(f"[blur] table uploads so far, by device: {json.dumps(dict(bt.TABLE_UPLOADS))}")
    phase_ms = {n: sum(s[n] for s in steady) / len(steady) for n in stages}
    total_ms = sum(phase_ms.values())
    print(f"[blur] steady pass per stage (ms, mean of 3, CUDA events): "
          f"{json.dumps({k: round(v, 3) for k, v in phase_ms.items()})}; total {total_ms:.3f} ms")

    rounds_hist = torch.bincount(rounds.flatten().long(), minlength=max_rounds + 1).tolist()
    print(f"[blur] rounds histogram (0..{max_rounds}): {rounds_hist}")
    check(int(rounds.max()) >= 1, "no block was blurred")
    check(blurred.shape == frames.shape and blurred.dtype == torch.uint8, "blurred shape")
    for row in rows:
        check(out[row].shape == frames.shape and out[row].dtype == torch.uint8,
              f"{row}: {tuple(out[row].shape)} {out[row].dtype}")
    for name, vals in metrics.items():
        for v in vals:
            check(bool(torch.isfinite(v).all()), f"{name} metric not finite: {v.tolist()}")
    untouched = (rounds == 0).repeat_interleave(B, -1).repeat_interleave(B, -2)[..., None]
    check(bool(untouched.any()), "no block with 0 rounds")
    check(torch.equal(torch.where(untouched, out["unsharp"], 0),
                      torch.where(untouched, blurred, 0)),
          "unsharp changed a block with 0 rounds")
    summary = {"frames": N, "height": H, "width": W, "block": B, "stage_ms": phase_ms,
               "blur_path_ms_per_clip": total_ms, "provenance": prov,
               "max_memory_allocated_bytes": peak}
    for name, vals in metrics.items():
        summary[f"psnr_{name}_db"] = vals[0].mean().item()
        summary[f"psnr_{name}_fg_db"] = vals[1].mean().item()
        if len(vals) == 3:
            summary[f"ssim_{name}"] = vals[2].mean().item()
    print("[blur] PSNR all / foreground (dB): " + "; ".join(
        f"{name} {summary[f'psnr_{name}_db']:.4f} / {summary[f'psnr_{name}_fg_db']:.4f}"
        for name in metrics))
    print("[blur] SSIM: " + ", ".join(f"{row} {summary[f'ssim_{row}']:.5f}" for row in rows))
    print(f"[blur] max_memory_allocated {peak} bytes")
    print(f"[blur] summary {json.dumps(summary)}")
    # sharpening a noisy clip may lose PSNR against the blurred frames (the
    # unsharp mask does); a broken restorer loses tens of dB
    for row in rows:
        check(summary[f"psnr_{row}_db"] > 25.0,
              f"{row} row at {summary[f'psnr_{row}_db']:.2f} dB: the restorer is broken")

    # reference on a small input: the blur slice on the card and on the CPU
    crop = frames[:2, :64, :96].contiguous()
    s_gpu, _ = score(crop, cfg)
    b_gpu, r_gpu = adaptive_blur(crop, s_gpu, B, max_rounds)
    b_cpu, r_cpu = adaptive_blur(crop.cpu(), s_gpu.cpu(), B, max_rounds)
    check(torch.equal(r_gpu.cpu(), r_cpu), "rounds maps card vs CPU")
    d_gpu, l_gpu = adaptive_downsample(crop, s_gpu, B)
    cpu_unsharp, _ = resolve_deblur_backend("unsharp", cfg, device="cpu")
    pairs = {
        "blurred": (b_gpu.cpu(), b_cpu),
        "unsharp": (unsharp(b_gpu, r_gpu, B).cpu(), cpu_unsharp(b_gpu.cpu(), r_cpu, B)),
        "lanczos": (restore_downsample_lanczos(d_gpu, l_gpu, B).cpu(),
                    restore_downsample_lanczos(d_gpu.cpu(), l_gpu.cpu(), B)),
    }
    lsbs = {k: (a.int() - b.int()).abs().max().item() for k, (a, b) in pairs.items()}
    for k, v in lsbs.items():
        check(v <= 1, f"{k} crop card vs CPU: {v} LSB")
    # The net twice. In float32 on both sides its output is held to 1 LSB
    # and 0.01 dB: the check of the port on the card. In its default bf16
    # body cuDNN and the CPU kernels round the conv sums at different
    # places, which this net turns into a few grey levels on single pixels
    # and up to 0.15 dB per frame (see tests/test_torch_blur_slice.py), so
    # the bf16 rows are held to 0.25 dB per frame.
    cpu_deblur, _ = resolve_deblur_backend(cfg.deblur_backends[0], cfg, device="cpu")
    net_err = {}
    for dtype, tol_db in ((torch.bfloat16, 0.25), (torch.float32, 0.01)):
        for fn in (deblur, cpu_deblur):
            fn.net.dtype = dtype
        n_gpu, n_cpu = deblur(b_gpu, r_gpu, B).cpu(), cpu_deblur(b_gpu.cpu(), r_cpu, B)
        p_err = (masked_psnr(crop.cpu(), n_gpu)
                 - masked_psnr(crop.cpu(), n_cpu)).abs().max().item()
        lsb = (n_gpu.int() - n_cpu.int()).abs().max().item()
        net_err[str(dtype).split(".")[-1]] = f"max {lsb} LSB, PSNR {p_err:.4f} dB (tol {tol_db})"
        check(p_err <= tol_db, f"deblur net ({dtype}) PSNR card vs CPU differs by {p_err} dB")
        check(dtype != torch.float32 or lsb <= 1, f"float32 deblur net card vs CPU: {lsb} LSB")
    deblur.net.dtype = torch.bfloat16
    print(f"[reference] 2x64x96 crop, blur slice, card vs CPU: rounds maps equal; "
          f"{', '.join(f'{k} {v} LSB' for k, v in lsbs.items())}; deblur net "
          f"{'; '.join(f'{k}: {v}' for k, v in net_err.items())}")
    return launches


class Stopwatch:
    """Times of named stretches: ``dev`` by CUDA events (the device's time
    from the first kernel enqueued in the stretch to the last one finished),
    ``wall`` by the host's clock with a synchronise at both ends."""

    def __init__(self):
        self.ms = {}

    def run(self, name, fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        self.ms[name] = {"wall": (time.perf_counter() - t0) * 1e3,
                         "dev": start.elapsed_time(end)}
        return out


def phase_codec(main, profile=False):
    """The main path through the NVC codec at full width: scores -> adaptive
    downsample -> encode at the target bitrate -> decode -> strength-map
    sidecars out and in -> progressive restore with the maps read back ->
    masked PSNR / SSIM and the row's bits; the baseline row; then the
    per-stage timing table at fixed QP (``codec_timing_table``) and the
    codec's own checks (``codec_checks``). Returns the path's kernel
    launches."""
    import tempfile

    import numpy as np

    from elvis_tpu_torch.codec import calculate_target_bitrate
    from elvis_tpu_torch.codec import sidecar
    from elvis_tpu_torch.codec.dispatch import make_pipeline_codec
    from elvis_tpu_torch.codec.nvc import codec as nvc
    from elvis_tpu_torch.codec.nvc import entropy, transform
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.metrics import masked_psnr, masked_ssim
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    dev = torch.device("cuda")
    cfg = ElvisConfig()
    frames, fg = main["frames"], main["fg"]
    fps, gop = 30.0, 30

    # the range coder, built from the checkout's source by the host compiler
    t0 = time.time()
    check(entropy.native_available(), "the native range coder did not build")
    built = entropy.BUILD_SECONDS
    print(f"[codec] range coder {entropy._lib_path().name}: "
          + (f"built by g++ in {built:.1f} s" if built is not None else "found built")
          + f", loaded in {time.time() - t0:.1f} s")

    # the two pinned numbers, card against CPU: exact
    mags = torch.arange(0, 32768, dtype=torch.float32)
    model = np.where(np.arange(32768) > 0,
                     2.0 * np.ceil(np.log2(np.arange(32768, dtype=np.float64) + 1.0)) + 2.0, 0.05)
    bits_card = transform._level_bits(mags.to(dev)).cpu()
    check(torch.equal(bits_card, transform._level_bits(mags)),
          "the bit model differs between the card and the CPU")
    check(np.array_equal(bits_card.numpy(), model.astype(np.float32)),
          "the bit model is not 2*ceil(log2(l+1))+2 on the card")
    log2_card = torch.where(mags > 0, 2.0 * torch.ceil(torch.log2(mags.to(dev) + 1.0).cpu()) + 2.0,
                            0.05)
    qps = torch.arange(52)
    check(torch.equal(transform.qstep_from_qp(qps.to(dev)).cpu(), transform.qstep_from_qp(qps)),
          "the Qstep table differs between the card and the CPU")
    exp2_card = torch.exp2((qps.to(dev).float() - 4.0) / 6.0).cpu()
    print(f"[codec] bit model at levels 0..32767 and Qstep at QP 0..51: card = CPU exactly; "
          f"the card's own log2 would move {int((log2_card != bits_card).sum())} levels, its "
          f"exp2 differs from the table at {int((exp2_card != transform.qstep_from_qp(qps)).sum())}"
          f" of 52 QPs")

    target = cfg.target_bitrate_override or calculate_target_bitrate(W, H, fps,
                                                                     cfg.quality_factor)
    codec = make_pipeline_codec(cfg.codec, "", W, H, quality=cfg.quality_preset,
                                nvc_b_frames=cfg.nvc_b_frames, nvc_me_radius=cfg.nvc_me_radius,
                                nvc_multi_ref=cfg.nvc_multi_ref, nvc_deblock=cfg.nvc_deblock,
                                nvc_intra_pred=cfg.nvc_intra_pred, device=dev)
    restore, prov = resolve_sr_backend(cfg.sr_backends[0], cfg, device=dev)
    enc_kw = dict(target_bitrate=target, framerate=fps, gop=gop)
    duration = N / fps

    # every full encode the rate targeting makes goes through nvc.encode
    full_encodes = []
    plain_encode = nvc.encode

    def counting_encode(frames_, **kw):
        full_encodes.append(kw.get("qp"))
        return plain_encode(frames_, **kw)

    def all_native(stream, what):
        backends = nvc.section_backends(stream)
        check(all(b == entropy.BACKEND_NATIVE for b in backends),
              f"{what}: a section was not written by the native range coder: {backends}")
        return len(backends)

    sw = Stopwatch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nvc.encode = counting_encode
    try:
        with tempfile.TemporaryDirectory() as tmp:
            LAUNCHES.clear()
            scores, _ = sw.run("scoring", lambda: score(frames, cfg))
            degraded, levels = sw.run("adaptive_downsample",
                                      lambda: adaptive_downsample(frames, scores, B))
            stream = sw.run("encode", lambda: codec.encode(degraded, **enc_kw))
            row_encodes = list(full_encodes)
            decoded = sw.run("decode", lambda: codec.decode(stream))
            levels_np = levels.cpu().numpy()
            npz_path, nvsv_path = f"{tmp}/downsample_maps.npz", f"{tmp}/downsample_maps.nvsv"
            npz_size = sw.run("sidecar_npz_out", lambda: sidecar.save_strength_maps_npz(
                levels_np, npz_path))
            maps_npz = sw.run("sidecar_npz_in", lambda: sidecar.load_strength_maps_npz(npz_path))
            nvsv_size = sw.run("sidecar_video_out", lambda: sidecar.save_strength_maps_video(
                levels_np, nvsv_path, framerate=fps,
                target_bitrate=cfg.strength_maps_target_bitrate, device=dev))
            maps_video = sw.run("sidecar_video_in",
                                lambda: sidecar.load_strength_maps_video(nvsv_path, device=dev))
            with open(nvsv_path, "rb") as f:
                sidecar_stream = f.read()[12:]
            use_npz = cfg.strength_maps_use_npz
            maps_back = torch.as_tensor((maps_npz if use_npz else maps_video).astype(np.int32),
                                        device=dev)
            restored = sw.run("progressive_restore", lambda: restore(decoded, maps_back, B))
            metrics = sw.run("metrics", lambda: {
                "decoded": (masked_psnr(frames, decoded), masked_psnr(frames, decoded, fg),
                            masked_ssim(frames, decoded)),
                "restored": (masked_psnr(frames, restored), masked_psnr(frames, restored, fg),
                             masked_ssim(frames, restored)),
                "degraded_undecoded": (masked_psnr(frames, degraded),),
            })
            launches = dict(LAUNCHES)
        peak_path = torch.cuda.max_memory_allocated()

        # the baseline row: the original clip through the codec at the same target
        full_encodes.clear()
        base_stream = sw.run("baseline_encode", lambda: codec.encode(frames, **enc_kw))
        base_encodes = list(full_encodes)
        base_decoded = sw.run("baseline_decode", lambda: codec.decode(base_stream))
    finally:
        nvc.encode = plain_encode
    base_metrics = (masked_psnr(frames, base_decoded), masked_psnr(frames, base_decoded, fg),
                    masked_ssim(frames, base_decoded))

    check(launches.get("block_transform", 0) == 1,
          f"the codec path launches block_transform once (adaptive_downsample): {launches}")
    print(f"[codec] kernel launches on the codec path: {json.dumps(launches)}")
    sections = all_native(stream, "the PRESLEY stream") + all_native(base_stream, "the baseline") \
        + all_native(sidecar_stream, "the video sidecar")
    print(f"[codec] all {sections} sections of the three streams made here were written by the "
          f"native range coder")
    check(decoded.shape == frames.shape and decoded.dtype == torch.uint8 and decoded.is_cuda,
          f"decoded {tuple(decoded.shape)} {decoded.dtype} {decoded.device}")
    check(restored.shape == frames.shape and restored.dtype == torch.uint8, "restored shape")
    check(np.array_equal(maps_npz, levels_np), "the npz sidecar did not bring the levels back")
    video_equal = float((maps_video == levels_np).mean())
    video_maxdiff = int(np.abs(maps_video.astype(int) - levels_np.astype(int)).max())
    # the video sidecar is lossy by design: its share of equal levels is reported
    check(maps_video.shape == levels_np.shape and maps_video.dtype == np.uint8,
          f"the video sidecar came back as {maps_video.shape} {maps_video.dtype}")
    info, base_info = codec._codec.probe(stream), codec._codec.probe(base_stream)
    check((info.width, info.height, info.num_frames) == (W, H, N), f"header {info}")
    sidecar_size = npz_size if use_npz else nvsv_size
    row_bits = (len(stream) + sidecar_size) * 8
    base_bits = len(base_stream) * 8
    summary = {
        "frames": N, "height": H, "width": W, "gop": gop, "target_bitrate": target,
        "presley": {
            "stream_bytes": len(stream), "qp": info.base_qp, "full_encodes": row_encodes,
            "sidecar": "npz" if use_npz else "video", "sidecar_npz_bytes": npz_size,
            "sidecar_video_bytes": nvsv_size, "sidecar_video_levels_equal": video_equal,
            "bits": row_bits, "bitrate": row_bits / duration,
        },
        "baseline": {"stream_bytes": len(base_stream), "qp": base_info.base_qp,
                     "full_encodes": base_encodes, "bits": base_bits,
                     "bitrate": base_bits / duration},
        "stage_ms": sw.ms, "max_memory_allocated_bytes": peak_path, "provenance": prov,
    }
    for name, vals in {**metrics, "baseline": base_metrics}.items():
        for key, v in zip(("psnr_%s_db", "psnr_%s_fg_db", "ssim_%s"), vals):
            check(bool(torch.isfinite(v).all()), f"{name} metric not finite: {v.tolist()}")
            summary[key % name] = v.mean().item()
    print(f"[codec] target {target} bit/s = {target * duration / 8:.0f} bytes for {N} frames at "
          f"{fps:g} fps, gop {gop}")
    print(f"[codec] PRESLEY row: QP {info.base_qp} after full encodes at QP {row_encodes}; stream "
          f"{len(stream)} bytes + sidecar {sidecar_size} ({summary['presley']['sidecar']}; npz "
          f"{npz_size}, video {nvsv_size} with {video_equal:.2%} of levels equal, max difference "
          f"{video_maxdiff}) = {row_bits} bits = {row_bits / duration:.0f} bit/s")
    print(f"[codec] PRESLEY row PSNR all / fg (dB), SSIM: degraded before the codec "
          f"{summary['psnr_degraded_undecoded_db']:.4f}; decoded {summary['psnr_decoded_db']:.4f} "
          f"/ {summary['psnr_decoded_fg_db']:.4f}, {summary['ssim_decoded']:.5f}; restored "
          f"{summary['psnr_restored_db']:.4f} / {summary['psnr_restored_fg_db']:.4f}, "
          f"{summary['ssim_restored']:.5f}")
    print(f"[codec] baseline row: QP {base_info.base_qp} after full encodes at QP {base_encodes}; "
          f"{len(base_stream)} bytes = {base_bits} bits = {base_bits / duration:.0f} bit/s; PSNR "
          f"{summary['psnr_baseline_db']:.4f} / {summary['psnr_baseline_fg_db']:.4f} dB, SSIM "
          f"{summary['ssim_baseline']:.5f}")
    print("[codec] path stages, ms (wall with a synchronise at both ends / CUDA events): "
          + "; ".join(f"{k} {v['wall']:.1f} / {v['dev']:.1f}" for k, v in sw.ms.items()))
    print(f"[codec] max_memory_allocated over the path {peak_path} bytes")
    check(summary["psnr_decoded_db"] > 25.0 and summary["psnr_baseline_db"] > 25.0,
          "a decoded row is below 25 dB: the codec is broken")
    check(summary["psnr_restored_db"] > summary["psnr_decoded_db"] - 1.0,
          "restore made the decoded clip much worse")
    for what, size, q in (("PRESLEY", len(stream), info.base_qp),
                          ("baseline", len(base_stream), base_info.base_qp)):
        # at QP 0 or 51 the rate model has run out of QPs, not failed
        check(q in (0, 51) or 0.5 <= size * 8 / (target * duration) <= 1.5,
              f"{what} stream of {size} bytes at QP {q} misses the target by more than half")

    fixed = codec_timing_table(frames, cfg, fps, gop, profile)
    codec_checks(frames, cfg, fps, gop, *fixed)
    print(f"[codec] summary {json.dumps(summary)}")
    return launches


def codec_timing_table(frames, cfg, fps, gop, profile=False, qp=32):
    """One encode and one decode of the clip at fixed QP, stage by stage: the
    device half by CUDA events, the host half by the host's clock, an intra
    frame alone, bytes each way, peak memory; then the hot spots of the
    device half on one luma plane, each alone. Returns the QP, the stream
    and the decoded frames."""
    import numpy as np

    from elvis_tpu_torch.codec.nvc import codec as nvc
    from elvis_tpu_torch.codec.nvc import transform
    from elvis_tpu_torch.ops.color import yuv420_to_rgb

    dev = frames.device
    pad = nvc._pad_to(frames, nvc._PAD)
    hp, wp = pad.shape[1:3]
    qp_y = nvc._qp_maps(N, hp // 8, wp // 8, qp, None)
    qp_c = nvc._chroma_qp(qp_y)
    qy, qc = torch.as_tensor(qp_y, device=dev), torch.as_tensor(qp_c, device=dev)
    flags = dict(multi_ref=cfg.nvc_multi_ref, deblock=cfg.nvc_deblock,
                 intra_pred=cfg.nvc_intra_pred)
    radius = cfg.nvc_me_radius
    tw = Stopwatch()
    nvc._encode_planes(pad[:2], qy[:2], qc[:2], gop, radius, 1, True, **flags)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    planes_dev, _ = tw.run("encode device: colour + 3 x encode_plane", lambda: nvc._encode_planes(
        pad, qy, qc, gop, radius, 1, True, **flags))
    peak_enc = torch.cuda.max_memory_allocated()
    tw.run("encode device, intra frame alone", lambda: nvc._encode_planes(
        pad[:1], qy[:1], qc[:1], gop, radius, 1, True, **flags))
    planes = tw.run("encode host: levels, modes, vectors to the host", lambda: nvc._to_host(
        planes_dev))
    down_bytes = sum(a.nbytes for plane in planes for a in plane)
    stream_q = tw.run("encode host: zigzag + DPCM + range coder", lambda: nvc.write_stream(
        planes, width=W, height=H, qp=qp, framerate=fps, gop=gop, deblock=cfg.nvc_deblock))
    parsed = tw.run("decode host: parse + range decoder + un-zigzag",
                    lambda: nvc.read_stream(stream_q))
    _, qp_y2, planes2 = parsed
    for a, b in zip(planes, planes2):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              "the stream did not bring the levels, modes and vectors back")
    sizes = ((hp, wp), (hp // 2, wp // 2), (hp // 2, wp // 2))
    qps3 = (qp_y2, nvc._chroma_qp(qp_y2), nvc._chroma_qp(qp_y2))
    up_bytes = sum(a.nbytes for plane in planes2 for a in plane) + sum(q.nbytes for q in qps3)

    def decode_dev(k):
        recons = nvc._decode_planes([tuple(a[:k] for a in pl) for pl in planes2],
                                    [q[:k] for q in qps3], sizes, dev, bfr=0,
                                    deblock=cfg.nvc_deblock)
        return torch.clamp(torch.round(yuv420_to_rgb(*recons)), 0, 255).to(torch.uint8)[:, :H, :W]

    decode_dev(2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rgb_q = tw.run("decode device: upload + 3 x decode_plane + colour", lambda: decode_dev(N))
    peak_dec = torch.cuda.max_memory_allocated()
    tw.run("decode device, intra frame alone", lambda: decode_dev(1))
    ms = tw.ms
    e_dev, e_i = ms["encode device: colour + 3 x encode_plane"], \
        ms["encode device, intra frame alone"]
    d_dev, d_i = ms["decode device: upload + 3 x decode_plane + colour"], \
        ms["decode device, intra frame alone"]
    e_host = ms["encode host: levels, modes, vectors to the host"]["wall"] \
        + ms["encode host: zigzag + DPCM + range coder"]["wall"]
    d_host = ms["decode host: parse + range decoder + un-zigzag"]["wall"]
    e_total, d_total = e_dev["wall"] + e_host, d_dev["wall"] + d_host
    print(f"[codec-timing] fixed QP {qp}, {N} frames {W}x{H}, gop {gop} (1 intra + {N - 1} P), "
          f"stream {len(stream_q)} bytes; ms as wall / CUDA events:")
    for k, v in ms.items():
        print(f"[codec-timing]   {k}: {v['wall']:.1f} / {v['dev']:.1f}")
    print(f"[codec-timing] encode {e_total:.1f} ms = {e_total / N:.1f} ms a frame, host part "
          f"{e_host:.1f} ms ({e_host / e_total:.1%}); intra frame {e_i['wall']:.1f} ms, P frame "
          f"{(e_dev['wall'] - e_i['wall']) / (N - 1):.1f} ms (device part, wall); "
          f"{down_bytes} bytes to the host; peak memory {peak_enc} bytes")
    print(f"[codec-timing] decode {d_total:.1f} ms = {d_total / N:.1f} ms a frame, host part "
          f"{d_host:.1f} ms ({d_host / d_total:.1%}); intra frame {d_i['wall']:.1f} ms, P frame "
          f"{(d_dev['wall'] - d_i['wall']) / (N - 1):.1f} ms (device part, wall); "
          f"{up_bytes} bytes to the card; peak memory {peak_dec} bytes")

    # hot spots of the device half, luma plane of one frame, each alone
    y = pad[:2].float()
    y = 0.299 * y[..., 0] + 0.587 * y[..., 1] + 0.114 * y[..., 2]
    blocks, qs = transform._blocks_of(y[1]), transform.qstep_from_qp(qy[1])
    mv_int = transform._motion_search(y[0], blocks, radius, 1)
    spots = {
        f"_intra_frame_encode ({hp // 8} block rows)":
            lambda: transform._intra_frame_encode(blocks, qs),
        "_intra_frame_decode": lambda: transform._intra_frame_decode(
            blocks, torch.zeros_like(qs, dtype=torch.int8), qs),
        f"_motion_search radius {radius} ({(2 * radius + 1) ** 2} shifts)":
            lambda: transform._motion_search(y[0], blocks, radius, 1),
        "_halfpel_refine (9 predictions)": lambda: transform._halfpel_refine(y[0], blocks, mv_int),
        "_motion_predict": lambda: transform._motion_predict(y[0], mv_int * 2),
        "block_dct2 + _quantize + _rd_cost": lambda: (lambda c: transform._rd_cost(
            transform._quantize(c, qs), c, qs))(transform.block_dct2(blocks)),
        "deblock_plane": lambda: transform.deblock_plane(y[0], qs),
    }
    hot = Stopwatch()
    for label, fn in spots.items():
        fn()
        hot.run(label, fn)
        print(f"[codec-timing] luma plane {wp}x{hp}, {label}: {hot.ms[label]['wall']:.2f} ms "
              f"wall / {hot.ms[label]['dev']:.2f} ms CUDA events")
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        for label in list(spots)[:4]:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                spots[label]()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            rows.sort(key=lambda r: -r[1])
            busy, count = sum(r[1] for r in rows), sum(r[2] for r in rows)
            check(busy > 0, f"torch.profiler saw no device time in {label}")
            print(f"[profile] {label}: {count} device kernels busy {busy:.2f} ms = "
                  f"{busy / hot.ms[label]['wall']:.1%} of its {hot.ms[label]['wall']:.2f} ms wall "
                  f"with the profiler off")
            for key, kms, kcount in rows[:5]:
                print(f"[profile]   {kms:9.3f} ms  x{kcount:<5d} {key[:100]}")

    return qp, stream_q, rgb_q


def codec_checks(frames, cfg, fps, gop, qp, stream_q, rgb_q):
    """The codec's own checks on the card: the staged decode is ``decode``,
    an encode repeats byte for byte, the chunked encode equals the single
    loop, and a crop's streams decode alike on the card and on the CPU."""
    from elvis_tpu_torch.codec.nvc import codec as nvc
    from elvis_tpu_torch.metrics import masked_psnr

    dev = frames.device
    flags = dict(me_radius=cfg.nvc_me_radius, multi_ref=cfg.nvc_multi_ref,
                 deblock=cfg.nvc_deblock, intra_pred=cfg.nvc_intra_pred)
    check(torch.equal(rgb_q, nvc.decode(stream_q, device=dev)[0]),
          "the staged decode differs from decode()")
    again = nvc.encode(frames, qp=qp, framerate=fps, gop=gop, **flags)
    check(again == stream_q, "two encodes of the same clip on the card differ "
                             f"({len(again)} and {len(stream_q)} bytes)")
    check(torch.equal(nvc.decode(again, device=dev)[0], rgb_q), "two decodes differ")
    chunked = nvc.encode(frames, qp=qp, framerate=fps, gop=gop, chunk_frames=4, **flags)
    check(chunked == stream_q, "the chunked encode (4 frames a segment) differs from the "
                               "single loop")
    psnr_q = masked_psnr(frames, rgb_q).mean().item()
    print(f"[codec] fixed QP {qp}: {len(stream_q)} bytes, PSNR {psnr_q:.4f} dB; the same encode "
          f"twice: identical bytes and frames; chunked (4 frames a segment): identical bytes")
    crop = frames[:2, :128, :192].contiguous()
    s_card = nvc.encode(crop, qp=qp, framerate=fps, gop=gop)
    s_cpu = nvc.encode(crop.cpu(), qp=qp, framerate=fps, gop=gop)
    cc, ch = nvc.decode(s_card, device=dev)[0].cpu(), nvc.decode(s_card, device="cpu")[0]
    hc = nvc.decode(s_cpu, device=dev)[0].cpu()
    lsb = max((cc.int() - ch.int()).abs().max().item(),
              (hc.int() - nvc.decode(s_cpu, device="cpu")[0].int()).abs().max().item())
    check(lsb <= 1, f"a stream decodes {lsb} LSB apart on the card and on the CPU")
    p_cc = masked_psnr(crop.cpu(), cc).mean().item()
    p_hc = masked_psnr(crop.cpu(), nvc.decode(s_cpu, device="cpu")[0]).mean().item()
    print(f"[reference] 2x128x192 crop at QP {qp}: card stream {len(s_card)} bytes, CPU stream "
          f"{len(s_cpu)} bytes ({'identical' if s_card == s_cpu else 'not identical'}); either "
          f"stream decoded on the card and on the CPU: max {lsb} LSB (tol 1); PSNR card-card "
          f"{p_cc:.4f} dB, CPU-CPU {p_hc:.4f} dB")
    check(abs(p_cc - p_hc) <= 0.05, "card and CPU encodes differ by more than 0.05 dB")


def phase_profile(main):
    """Device time by kernel of one steady call of each neural restorer and
    of each transform stage. In a transform stage every device kernel but
    the transform itself must be small: a pass over the whole clip (a cast,
    a copy, a round, a clamp) takes 0.03 ms or more on this card."""
    from torch.profiler import ProfilerActivity, profile

    from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore import restore_blur_unsharp, restore_downsample_lanczos
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend, resolve_sr_backend

    cfg = ElvisConfig()
    dev = torch.device("cuda")
    restore, _ = resolve_sr_backend(cfg.sr_backends[0], cfg, device=dev)
    deblur, _ = resolve_deblur_backend(cfg.deblur_backends[0], cfg, device=dev)
    blurred, rounds = adaptive_blur(main["frames"], main["scores"], B, cfg.gaussian_max_rounds)
    calls = {"progressive_restore": lambda: restore(main["degraded"], main["levels"], B),
             "deblur_net": lambda: deblur(blurred, rounds, B)}
    transform_stages = {
        "adaptive_downsample": lambda: adaptive_downsample(main["frames"], main["scores"], B),
        "adaptive_blur": lambda: adaptive_blur(main["frames"], main["scores"], B,
                                               cfg.gaussian_max_rounds),
        "unsharp": lambda: restore_blur_unsharp(blurred, rounds, B, cfg.gaussian_max_rounds),
        "lanczos": lambda: restore_downsample_lanczos(main["degraded"], main["levels"], B),
    }
    calls.update(transform_stages)
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3  # host clock, profiler off
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only: an operator's row repeats its kernels' time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        check(busy > 0, f"torch.profiler saw no device time in {label}")
        print(f"[profile] {label}: {wall_ms:.2f} ms wall with the profiler off; kernels busy "
              f"{busy:.2f} ms under the profiler ({busy / wall_ms:.1%} of that wall); top kernels "
              f"by device time:")
        for key, ms, count in rows[:10]:
            print(f"[profile]   {ms:9.3f} ms  {ms / busy:6.1%}  x{count:<5d} {key[:100]}")
        if label in transform_stages:
            ours = [r for r in rows if "block_transform_kernel" in r[0]]
            rest = [r for r in rows if "block_transform_kernel" not in r[0]]
            check(len(ours) == 1 and ours[0][2] == 1,
                  f"{label}: expected one launch of the transform kernel, saw {ours}")
            big = [r for r in rest if r[1] / r[2] >= 0.02]
            check(not big, f"{label}: a full-clip pass runs beside the transform kernel: {big}")
            print(f"[profile] {label}: transform kernel {ours[0][1]:.4f} ms; {len(rest)} other "
                  f"device kernel name(s), {sum(r[1] for r in rest):.4f} ms together, none "
                  f"over 0.02 ms a launch")
            # back to back the stage costs the larger of the host's time to
            # enqueue it and the device's time to run it
            print(f"[profile] {label}: {cuda_ms(fn, iters=100):.4f} ms a call over 100 calls "
                  f"back to back (CUDA events)")


PIPELINE_ROWS = ("Baseline", "PRESLEY QP", "ELVIS CV2", "ELVIS ProPainter", "ELVIS E2FGVI",
                 "PRESLEY RealESRGAN", "PRESLEY InstantIR", "PRESLEY Lanczos", "PRESLEY Unsharp")
# the JAX package's top-level keys of analysis_results.json (tests/test_pipeline.py)
PIPELINE_KEYS = ("execution_times_seconds", "video_name", "video_length_seconds",
                 "video_framerate", "video_resolution", "block_size", "target_bitrate_bps",
                 "parameters", "experiment_dir", "analysis_results_path")
# the cached stages of the default config: scoring, five encodes, five restores
PIPELINE_STAGES = ("scoring", "baseline_encode", "shrink_encode", "roi_encode",
                   "downsample_encode", "gaussian_encode", "inpaint_diffusion", "inpaint_temporal",
                   "inpaint_neural", "sr_realesrgan", "deblur_deblur_net")
# stage 8's timers of the two fills this slice adds
FILL_STAGES = ("ProPainter Inpainting", "E2FGVI Inpainting")
# phase 7's card-vs-CPU crop (rows, columns) and the net's bounds there, bf16
# on both sides: max abs over hole pixels in grey levels (the card read 0.38
# on this crop and 0.46 on the card test's clip), and the mean error as a
# share of the CPU's mean residual (read 0.27%)
CROP = (256, 512)
NET_GREY_TOL = 1.0
NET_RESIDUAL_TOL = 0.02
# phase 8: every backend of the JAX package's remaining names whose weights
# ship, on top of the default config
BACKEND_NAMES = dict(
    sr_backends=["realesrgan", "srnet_large", "srnet_4k", "lanczos", "hybrid", "level_seq",
                 "naive_sr"],
    deblur_backends=["deblur_net", "diffusion", "naive_diffusion"],
    enable_dct_dampen=True, saliency_backend="neural")
BACKEND_ROWS = ("Baseline", "PRESLEY QP", "ELVIS v2 Dampen", "ELVIS CV2", "ELVIS ProPainter",
                "ELVIS E2FGVI", "PRESLEY RealESRGAN",
                *(f"PRESLEY SR {n}" for n in BACKEND_NAMES["sr_backends"][1:]),
                "PRESLEY InstantIR",
                *(f"PRESLEY Deblur {n}" for n in BACKEND_NAMES["deblur_backends"][1:]),
                "PRESLEY Lanczos", "PRESLEY Unsharp")
# transform launches of that run: the downsample and blur degrades, the
# 'lanczos' row, the Lanczos half of 'hybrid', the two classical rows
BACKEND_TRANSFORM_LAUNCHES = 6
# the diffusion restore on the card against the CPU (bf16 on both sides,
# the same noise), grey levels: max abs and mean abs over the crop. The card
# read 0.206 / 0.018 on this crop and 0.431 / 0.035 on the card test's clip,
# against a mean change of the input of 3.7 and 7.6 grey levels
DIFFUSION_MAX_GREY = 1.0
DIFFUSION_MEAN_GREY = 0.1
# phase 9: the RRDB tier and the ensemble beside the generic slot, through
# x265 at the 'slow' preset (under the codec shim: no encoder binary exists
# on the card's machine)
EXTERNAL_NAMES = dict(codec="x265", encode_preset="slow",
                      sr_backends=["realesrgan", "srnet", "srnet_ensemble"])
EXTERNAL_ROWS = (*PIPELINE_ROWS[:6], "PRESLEY SR srnet", "PRESLEY SR srnet_ensemble",
                 *PIPELINE_ROWS[6:])
EXTERNAL_BINARIES = ("x265", "kvazaar", "SvtAv1EncApp", "mkvmerge", "ffmpeg")
# the SR crop on the card against the CPU (2 frames; a CPU pass of the RRDB
# net and the ensemble on a larger crop takes minutes): uint8 within 1 LSB
# and 0.1 LSB on average (the SR names' bounds of tests/test_torch_srnet.py),
# restored PSNR within 0.05 dB
SR_CROP = (128, 256)
# phase 10: the PRESLEY sweep's rows at PresleyConfig()'s defaults, and its
# transform launches: the downsample, scale and blur degrades, the
# 'lanczos' and 'lanczos_tb' rows, the scale-Lanczos and unsharp rows
PRESLEY_TRANSFORM_LAUNCHES = 7
# phase 11: the parallel layer on logical shards of the one card
TALL = (4, 2160, 3840)  # the spatial restore's clip: frames, rows, columns (2160p)
# tiles of whole blocks: 2160 rows split 3 x 720 (4 x 540 is 67.5 blocks of 8,
# which spatial_tile_map_blocks refuses and run_elvis's spatial_ok skips)
TALL_TILES = 3
# the spatial halo: ElvisConfig's spatial_halo. 32 rows cover the progressive
# Lanczos loop at max_level 3 (the JAX package's bound), not the student's
# nine convs a stage: the phase prints 32's error beside 64's, and holds 64
TALL_HALO = 64
SHORT_HALO = 32
SHARD_U8_SHARE = 5e-3  # share of uint8 pixels a sharded restore may put 1 LSB off
# the sharded run: downsample and blur once, Lanczos and unsharp once per shard
PARALLEL_TRANSFORM_LAUNCHES = 6
# phase 12: the student at its shipped architecture, as train_srnet_student takes it
STUDENT = dict(features=256, num_convs=6, batch=16, patch=64)
# from the zero tail at the default 2e-4 the student needs more than 100
# steps to move the held-out loss; at 1e-3, 50 to 100 (CPU runs at 64 x 6)
TRAIN_STEPS = 100
TRAIN_LR = 1e-3
TRAIN_EXTRA_STEPS = 5  # deblur and srnet_4k
STEP_LR = 1e-4  # the sharded and card-vs-CPU step checks: constant learning rate
# the card-vs-CPU bf16 steps: a tensor fails when more of its elements than
# the larger of BF16_LEAST and BF16_SHARE of them moved apart by more than a
# quarter of the summed learning rate
BF16_LEAST = 2
BF16_SHARE = 0.05


def tensors_moved_apart(got, want, limit):
    """Two parameter dicts: per tensor, the elements farther apart than
    ``limit``, and the names of the tensors where more are than the larger
    of ``BF16_LEAST`` and ``BF16_SHARE`` of the tensor's elements. A share
    alone cannot be resolved on a small tensor (one element of a 12-element
    bias is 8%): the floor of two elements lets a near-zero gradient or two
    round apart, not a tensor that moved wrongly."""
    beyond = {n: int(((got[n] - want[n]).abs() > limit).sum()) for n in want}
    failing = sorted(n for n, c in beyond.items()
                     if c > max(BF16_LEAST, BF16_SHARE * want[n].numel()))
    return beyond, failing


def _rows(results):
    return [k for k, v in results.items() if isinstance(v, dict) and "foreground" in v]


def _rows_apart(a, b, relative=False):
    """Largest difference of each metric between two runs' rows: relative
    for the bitrate, absolute (or relative) for the rest."""
    worst = {}
    for row in _rows(b):
        worst["bitrate_rel"] = max(worst.get("bitrate_rel", 0.0),
                                   abs(a[row]["bitrate_mbps"] - b[row]["bitrate_mbps"])
                                   / b[row]["bitrate_mbps"])
        for region in ("foreground", "background"):
            for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
                d = abs(a[row][region][key] - b[row][region][key])
                if relative:
                    d /= max(abs(b[row][region][key]), 1e-12)
                worst[key] = max(worst.get(key, 0.0), d)
    return worst


def phase_pipeline(smi_line):
    """run_elvis at full width on the card, twice on one directory, then the
    small card run held to the CPU run. Returns the first run's launches and
    what phase 7 needs of the first run: the shrunk branch's stream and the
    removal sidecar."""
    import os
    import tempfile

    import numpy as np

    from elvis_tpu_torch.codec.nvc.codec import NvcCodec
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.metrics.vmaf import vmaf_available
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis

    print(f"[pipeline] vmaf binary {'found' if vmaf_available() else 'absent'}: the VMAF keys "
          f"{'are' if vmaf_available() else 'are not'} in the rows")
    with tempfile.TemporaryDirectory() as exp:
        cfg = ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W,
                          height=H, experiment_dir=exp)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        stats = {}
        LAUNCHES.clear()
        t0 = time.perf_counter()
        first = run_elvis(cfg, device="cuda", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peaks = stats["stage_peak_bytes"]
        peak = max(peaks.values())
        probe = NvcCodec("cpu").probe
        qps = {k: (probe(s).base_qp, len(s)) for k, s in stats["streams"].items()}
        with open(os.path.join(exp, "analysis_results.json")) as f:
            written = json.load(f)
        for rel in ("shrink_masks_8.npz", "maps/downsample_maps.npz", "maps/gaussian_maps.npz"):
            check(os.path.isfile(os.path.join(exp, rel)), f"run_elvis wrote no {rel}")
        masks = sorted(os.listdir(os.path.join(exp, "maps", "saliency_masks")))
        check(len(masks) == N, f"saliency masks: {len(masks)} PNGs for {N} frames")
        from elvis_tpu_torch.codec.sidecar import load_removal_masks_npz

        removal = load_removal_masks_npz(os.path.join(exp, "shrink_masks_8.npz"),
                                         with_motion=True)
        t0 = time.perf_counter()
        second = run_elvis(cfg, device="cuda")
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0

    times = first["execution_times_seconds"]
    print(f"[pipeline] run_elvis, {N} frames {W}x{H}, {smi_line}: {wall:.2f} s wall (first call "
          f"in this process), peak max_memory_allocated {peak} bytes ({base} bytes held by the "
          f"earlier phases)")
    print("[pipeline] peak max_memory_allocated by stage, bytes: " + json.dumps(peaks))
    print("[pipeline] execution_times_seconds: " + json.dumps(times))
    for stage in FILL_STAGES:
        check(stage in times and stage in peaks, f"no {stage} stage in the run")
        print(f"[pipeline] {stage}: {times[stage]:.3f} s, peak max_memory_allocated "
              f"{peaks[stage]} bytes")
    provs = first["parameters"]["derived"]["backends"]
    print(f"[pipeline] inpaint backends: {json.dumps({k: provs[k] for k in PIPELINE_ROWS[2:5]})}")
    check(all(provs[k].endswith("+motion_hint") for k in PIPELINE_ROWS[3:5]),
          "the temporal and neural fills did not read the motion hint")
    print(f"[pipeline] kernel launches in the run: {json.dumps(launches)}")
    check(launches.get("block_transform", 0) == 4,
          "one transform launch per degrade or classical stage (downsample, blur, Lanczos, "
          f"unsharp): {launches}")
    check(set(written) >= set(PIPELINE_KEYS), f"JSON keys {sorted(written)}")
    rows = _rows(first)
    check(rows == list(PIPELINE_ROWS), f"rows {rows}")
    duration = first["video_length_seconds"]
    branch_of = {"Baseline": "baseline", "PRESLEY QP": "roi", "ELVIS CV2": "shrunk",
                 "ELVIS ProPainter": "shrunk", "ELVIS E2FGVI": "shrunk",
                 "PRESLEY RealESRGAN": "downsampled", "PRESLEY Lanczos": "downsampled",
                 "PRESLEY InstantIR": "gaussian", "PRESLEY Unsharp": "gaussian"}
    print(f"[pipeline] target {first['target_bitrate_bps']} bit/s; stream QP and bytes by "
          f"branch: {json.dumps(qps)}")
    for row in rows:
        r = first[row]
        bits = r["bitrate_mbps"] * 1e6 * duration
        check(r["bitrate_mbps"] > 0, f"{row}: bitrate {r['bitrate_mbps']}")
        for region in ("foreground", "background"):
            for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
                check(np.isfinite(r[region][key]), f"{row} {region} {key} = {r[region][key]}")
        fg, bg = r["foreground"], r["background"]
        print(f"[pipeline] {row:<20} QP {qps[branch_of[row]][0]:>2}, {bits / 8:9.0f} bytes "
              f"(with sidecar), {r['bitrate_mbps'] * 1e6:11.0f} bit/s; fg/bg PSNR "
              f"{fg['psnr_mean']:.4f} / {bg['psnr_mean']:.4f} dB, SSIM {fg['ssim_mean']:.5f} / "
              f"{bg['ssim_mean']:.5f}, LPIPS {fg['lpips_mean']:.5f} / {bg['lpips_mean']:.5f}, "
              f"FVMD {fg['fvmd']:.4f} / {bg['fvmd']:.4f}")
    print(f"[pipeline] second run on the same directory: {wall2:.2f} s wall; stage cache "
          f"{json.dumps(second['stage_cache'])}; execution_times_seconds "
          f"{json.dumps(second['execution_times_seconds'])}")
    check(second["stage_cache"] == {"hits": list(PIPELINE_STAGES), "misses": []},
          f"the second run was not served from the stage cache: {second['stage_cache']}")
    apart = _rows_apart(second, first, relative=True)
    print(f"[pipeline] second run against the first, largest relative difference over the rows:"
          f" {json.dumps(apart)} (the bitrate must be equal; each metric within 1e-4: the "
          f"classical rows and the evaluation run again on the card)")
    check(apart["bitrate_rel"] == 0.0 and all(v <= 1e-4 for v in apart.values()),
          "the second run's rows differ")

    # the same pipeline at 6 frames of 96x64 on the card and on the CPU
    small = dict(reference_video="synthetic://moving?frames=6&fps=30", width=96, height=64,
                 enable_vmaf=False, stage_cache=False, target_bitrate_override=100_000,
                 verbose=False)
    with tempfile.TemporaryDirectory() as exp:
        card = run_elvis(ElvisConfig(experiment_dir=f"{exp}/card", **small), device="cuda")
        cpu = run_elvis(ElvisConfig(experiment_dir=f"{exp}/cpu", **small), device="cpu")
    check(_rows(card) == _rows(cpu) == list(PIPELINE_ROWS), "small run rows")
    worst = _rows_apart(card, cpu)
    print(f"[reference] run_elvis 6x96x64, card vs CPU, largest difference over the 9 rows: "
          f"{json.dumps(worst)} (tol bitrate 1%, PSNR 0.1 dB, SSIM 2e-3, LPIPS 1e-3); "
          f"relative: {json.dumps(_rows_apart(card, cpu, relative=True))}")
    check(worst["bitrate_rel"] <= 0.01 and worst["psnr_mean"] <= 0.1
          and worst["ssim_mean"] <= 2e-3 and worst["lpips_mean"] <= 1e-3,
          f"card and CPU runs differ: {worst}")

    # the PDE fill alone at full width: 200 eager iterations
    from torch.profiler import ProfilerActivity, profile

    from elvis_tpu_torch.degrade.removal import removal_mask_from_scores
    from elvis_tpu_torch.restore.inpaint import restore_removal_diffusion

    clip = make_clip(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scores = torch.rand((N, H // B, W // B), generator=gen, device="cuda")
    mask = removal_mask_from_scores(scores, W // B, 0.25, cooldown=1)
    fill_ms = cuda_ms(lambda: restore_removal_diffusion(clip, mask, B), iters=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        restore_removal_diffusion(clip, mask, B)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    print(f"[pipeline] PDE fill alone, {N}x{H}x{W}x3, 200 iterations, a quarter of the blocks "
          f"removed: {fill_ms:.2f} ms a call (CUDA events, mean of 3); {count} device kernels "
          f"busy {busy:.2f} ms under the profiler")

    # which part of the evaluation holds its peak: each alone on one metric
    # chunk (the clip against its noisy copy), memory above what was held
    from elvis_tpu_torch.metrics.evaluate import _EVAL_CHUNK_PIXELS
    from elvis_tpu_torch.metrics.fvmd import region_motion_features
    from elvis_tpu_torch.metrics.perceptual import lpips_distance
    from elvis_tpu_torch.metrics.pixel import masked_ssim

    k = max(1, _EVAL_CHUNK_PIXELS // (H * W))
    noisy = torch.clamp(clip.float() + 8.0 * torch.randn(clip.shape, generator=gen,
                                                         device="cuda"), 0, 255).to(torch.uint8)
    fg = clip[..., 0] > 128
    parts = {
        f"lpips_distance ({k} frames)": lambda: lpips_distance(clip[:k].float(),
                                                               noisy[:k].float()),
        f"masked_ssim ({k} frames)": lambda: masked_ssim(clip[:k].float(), noisy[:k].float(),
                                                         fg[:k]),
        f"region_motion_features ({N} frames)": lambda: region_motion_features(noisy, fg),
    }
    part_peaks = {}
    for label, fn in parts.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        part_peaks[label] = torch.cuda.max_memory_allocated() - held
    print("[pipeline] evaluation parts alone, peak max_memory_allocated above what was held, "
          "bytes: " + json.dumps(part_peaks))
    return launches, stats["streams"]["shrunk"], removal, first


def _timed_with_peak(fn, iters=3):
    """(ms a call by CUDA events, mean of ``iters`` after one warm-up; peak
    max_memory_allocated of one call above what was held, bytes)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    return cuda_ms(fn, iters=iters, warmup=0), peak


def phase_fills(smi_line, shrunk_stream, removal):
    """The temporal fill and the net alone at full width on the shrunk
    branch's decoded and stretched frames, through the backends stage 8
    resolves, with and without the transmitted motion hint."""
    from elvis_tpu_torch.codec.nvc.codec import decode
    from elvis_tpu_torch.degrade.removal import stretch_frames
    from elvis_tpu_torch.ops.motion import motion_field_from_hint
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.pipeline.run import _apply_temporal, _carry_tiling, _height_tile_plan
    from elvis_tpu_torch.restore.backends import resolve_inpaint_backend

    masks, gmv, dev = removal
    check(gmv is not None and dev is not None, "the removal sidecar carries no motion hint")
    mask = torch.as_tensor(masks.astype("int8"), device="cuda")
    decoded, _ = decode(shrunk_stream, device="cuda")
    stretched = stretch_frames(decoded, mask, B)
    field = motion_field_from_hint(torch.as_tensor(gmv, device="cuda"),
                                   torch.as_tensor(dev, device="cuda"), H // B, W // B)
    cfg = ElvisConfig()
    temporal, _ = resolve_inpaint_backend("temporal", cfg, device="cuda")
    neural, _ = resolve_inpaint_backend("neural", cfg, device="cuda")
    seed, post = neural.split, neural.split.post
    seeded = seed(stretched, mask, B, mv=field)
    staged = _carry_tiling(lambda f, m: post(f, m, B), post)
    tiles = _height_tile_plan(staged, seeded.shape, N)
    out = {}
    parts = {
        "temporal fill, motion hint": lambda: temporal(stretched, mask, B, mv=field),
        "temporal fill, estimated motion": lambda: temporal(stretched, mask, B),
        "E2FGVI seed, motion hint": lambda: seed(stretched, mask, B, mv=field),
        f"net post as stage 8 drives it (halo, window rows {tiles})":
            lambda: _apply_temporal(staged, (seeded, mask), overlap=post.temporal_overlap),
        "net post, one call": lambda: post(seeded, mask, B),
    }
    for label, fn in parts.items():
        ms, peak = _timed_with_peak(fn)
        out[label] = {"ms": round(ms, 3), "peak_bytes": peak}
        r = fn()
        check(r.shape == stretched.shape and bool(torch.isfinite(r.float()).all()),
              f"{label}: shape {tuple(r.shape)} or non-finite values")
    hole = mask.bool().repeat_interleave(B, 1).repeat_interleave(B, 2)
    for label in ("temporal fill, motion hint", "temporal fill, estimated motion"):
        r = parts[label]()
        check(torch.equal(r[~hole], stretched[~hole]), f"{label} changed known pixels")
    print(f"[fills] {N}x{H}x{W}, {int(mask.sum())} of {mask.numel()} blocks removed, "
          f"{smi_line}: " + json.dumps(out))

    # card against CPU on a centre crop of the same frames: the scatter
    # inverse adds with float atomics on the card, in no fixed order, and the
    # net's bf16 convolutions are cuDNN's there
    ch, cw = CROP
    y0 = (H // 2 - ch // 2) // (2 * B) * (2 * B)
    x0 = (W // 2 - cw // 2) // (2 * B) * (2 * B)
    rows, cols = slice(y0, y0 + ch), slice(x0, x0 + cw)
    brows, bcols = slice(y0 // B, (y0 + ch) // B), slice(x0 // B, (x0 + cw) // B)
    c_frames, c_mask = stretched[:, rows, cols], mask[:, brows, bcols]
    c_field = field[:, brows, bcols]
    c_hole = hole[:, rows, cols].cpu()
    net_cpu, _ = resolve_inpaint_backend("neural", cfg, device="cpu")
    apart = {}
    for label, mv in (("temporal fill, motion hint", c_field),
                      ("temporal fill, estimated motion", None)):
        card = temporal(c_frames, c_mask, B, mv=mv).cpu()
        cpu = temporal(c_frames.cpu(), c_mask.cpu(), B, mv=None if mv is None else mv.cpu())
        d = (card[c_hole].int() - cpu[c_hole].int()).abs()
        within = float((d <= 1).float().mean())
        known_equal = bool(torch.equal(card[~c_hole], cpu[~c_hole]))
        apart[label] = {"known_bit_equal": known_equal, "hole_within_1_lsb": within,
                        "hole_max_lsb": int(d.max())}
        check(known_equal and within >= 0.995,
              f"{label}, card vs CPU: {apart[label]} (known pixels bit-equal, at least 99.5% "
              "of hole pixels within 1 LSB)")
    c_seeded = seeded[:, rows, cols]
    card = post(c_seeded, c_mask, B).cpu()
    cpu = net_cpu.split.post(c_seeded.cpu(), c_mask.cpu(), B)
    net_err = float((card - cpu).abs()[c_hole].max())
    # the residual is the net's work: the card's must be the CPU's, not zero
    # and not noise the clamp and the hole mask would hide
    residual = float((cpu - c_seeded.cpu()).abs()[c_hole].mean())
    res_err = float((card - cpu).abs()[c_hole].mean()) / max(residual, 1e-9)
    apart["net post (bf16)"] = {"hole_max_abs_grey": net_err,
                                "cpu_hole_mean_residual_grey": residual,
                                "card_residual_mean_error_relative": res_err}
    print(f"[fills] card vs CPU on a {N}x{ch}x{cw} crop at ({y0}, {x0}): " + json.dumps(apart)
          + f" (temporal: known bit-equal, >= 99.5% of hole pixels within 1 LSB; net: hole "
          f"max abs <= {NET_GREY_TOL} grey levels < mean residual, mean error <= "
          f"{NET_RESIDUAL_TOL:.0%} of it)")
    check(net_err <= NET_GREY_TOL < residual and res_err <= NET_RESIDUAL_TOL,
          f"the net on the card against the CPU: {apart['net post (bf16)']}")


def phase_backends(smi_line):
    """run_elvis at full width with every remaining SR, deblur and saliency
    name whose weights ship and the DCT-dampen branch; then each new
    restorer alone on the same clip (CUDA events, peak memory), and on a
    centre crop the card held to the CPU. Returns the run's launches."""
    import os
    import tempfile
    import warnings

    import numpy as np

    from elvis_tpu_torch.degrade import adaptive_blur, adaptive_downsample, dct_dampen
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.metrics import masked_psnr
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.pipeline.run import _apply_framewise, _carry_tiling
    from elvis_tpu_torch.restore import RestoreFallbackWarning, restore_dct_dampen_inverse
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend, resolve_sr_backend
    from elvis_tpu_torch.scoring import get_saliency_fn, saliency_to_block_mask

    with tempfile.TemporaryDirectory() as exp:
        cfg = ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W,
                          height=H, experiment_dir=exp, **BACKEND_NAMES)
        torch.cuda.synchronize()
        stats = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            LAUNCHES.clear()
            t0 = time.perf_counter()
            run = run_elvis(cfg, device="cuda", stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
        check(os.path.isfile(os.path.join(exp, "maps", "dampen_maps.npz")),
              "run_elvis wrote no dampen sidecar")
    fallbacks = [str(w.message) for w in caught if issubclass(w.category, RestoreFallbackWarning)]
    check(not fallbacks, f"an out-of-memory fallback fired: {fallbacks}")
    times = run["execution_times_seconds"]
    peaks = stats["stage_peak_bytes"]
    print(f"[backends] run_elvis with {json.dumps(BACKEND_NAMES)}, {N} frames {W}x{H}, "
          f"{smi_line}: {wall:.2f} s wall; peak max_memory_allocated {max(peaks.values())} "
          f"bytes; no out-of-memory fallback")
    print("[backends] execution_times_seconds: " + json.dumps(times))
    print("[backends] peak max_memory_allocated by stage, bytes: " + json.dumps(peaks))
    print("[backends] backends: " + json.dumps(run["parameters"]["derived"]["backends"]))
    print(f"[backends] kernel launches in the run: {json.dumps(launches)}")
    check(launches.get("block_transform", 0) == BACKEND_TRANSFORM_LAUNCHES,
          f"{BACKEND_TRANSFORM_LAUNCHES} transform launches (two degrades, 'lanczos', "
          f"'hybrid', two classical rows): {launches}")
    rows = _rows(run)
    check(rows == list(BACKEND_ROWS), f"rows {rows}")
    for row in rows:
        r = run[row]
        for region in ("foreground", "background"):
            for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
                check(np.isfinite(r[region][key]), f"{row} {region} {key} = {r[region][key]}")
        fg, bg = r["foreground"], r["background"]
        print(f"[backends] {row:<31} {r['bitrate_mbps'] * 1e6:11.0f} bit/s; fg/bg PSNR "
              f"{fg['psnr_mean']:.4f} / {bg['psnr_mean']:.4f} dB, SSIM {fg['ssim_mean']:.5f} / "
              f"{bg['ssim_mean']:.5f}, LPIPS {fg['lpips_mean']:.5f} / {bg['lpips_mean']:.5f}, "
              f"FVMD {fg['fvmd']:.4f} / {bg['fvmd']:.4f}")
    check(run["ELVIS v2 Dampen"]["bitrate_mbps"] > 0, "the dampen row has no bits")

    # each new restorer alone on the clip, as its stage drives it
    clip = make_clip(torch.device("cuda"))
    base = ElvisConfig()
    scores, _ = score(clip, base)
    blurred, blur_lv = adaptive_blur(clip, scores, B, base.gaussian_max_rounds)
    down, down_lv = adaptive_downsample(clip, scores, B)
    damped, damp_lv = dct_dampen(clip, scores, B)
    sal_fn = get_saliency_fn("neural")
    diffusion, _ = resolve_deblur_backend("diffusion", base, device="cuda")
    sr = {n: resolve_sr_backend(n, base, device="cuda")[0]
          for n in ("srnet_large", "level_seq", "naive_sr")}

    def staged(fn):
        return lambda f, m: _apply_framewise(_carry_tiling(lambda a, b: fn(a, b, B), fn), f, m)

    parts = {
        f"diffusion restore_adaptive, 20 steps, {diffusion.frame_chunk} frames a call":
            lambda: staged(diffusion)(blurred, blur_lv),
        "saliency net": lambda: sal_fn(clip),
        "dct_dampen": lambda: dct_dampen(clip, scores, B)[0],
        "dct_dampen inverse": lambda: restore_dct_dampen_inverse(damped, damp_lv, B),
        **{f"{n} restore": (lambda fn=fn: staged(fn)(down, down_lv)) for n, fn in sr.items()},
    }
    alone = {}
    for label, fn in parts.items():
        ms, peak = _timed_with_peak(fn)
        out = fn()
        check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite values")
        alone[label] = {"ms": round(ms, 3), "peak_bytes": peak}
    print(f"[backends] {N}x{H}x{W}, each alone (CUDA events, mean of 3 after one warm-up; peak "
          f"max_memory_allocated above what was held), {smi_line}: " + json.dumps(alone))

    # card against CPU on a centre crop (the diffusion and SR nets on its
    # first two frames: a CPU pass of the whole crop takes minutes)
    ch, cw = CROP
    y0 = (H // 2 - ch // 2) // (2 * B) * (2 * B)
    x0 = (W // 2 - cw // 2) // (2 * B) * (2 * B)
    rows_, cols = slice(y0, y0 + ch), slice(x0, x0 + cw)
    brows, bcols = slice(y0 // B, (y0 + ch) // B), slice(x0 // B, (x0 + cw) // B)
    apart = {}
    c_clip, c_scores = clip[:, rows_, cols], scores[:, brows, bcols]
    d_card, l_card = dct_dampen(c_clip, c_scores, B)
    d_cpu, l_cpu = dct_dampen(c_clip.cpu(), c_scores.cpu(), B)
    i_card = restore_dct_dampen_inverse(d_card, l_card, B).cpu()
    i_cpu = restore_dct_dampen_inverse(d_card.cpu(), l_card.cpu(), B)
    apart["dct_dampen"] = {"levels_equal": bool(torch.equal(l_card.cpu(), l_cpu)),
                           "max_lsb": int((d_card.cpu().int() - d_cpu.int()).abs().max()),
                           "inverse_max_lsb": int((i_card.int() - i_cpu.int()).abs().max())}
    check(apart["dct_dampen"]["levels_equal"] and apart["dct_dampen"]["max_lsb"] <= 1
          and apart["dct_dampen"]["inverse_max_lsb"] <= 1,
          f"dct_dampen card vs CPU: {apart['dct_dampen']} (levels equal, within 1 LSB)")
    s_card = sal_fn(c_clip).cpu()
    s_cpu = get_saliency_fn("neural")(c_clip.cpu())
    agree = float((saliency_to_block_mask(s_card, B) == saliency_to_block_mask(s_cpu, B))
                  .float().mean())
    apart["saliency net"] = {"max_abs": float((s_card - s_cpu).abs().max()),
                             "block_masks_agree": agree}
    check(agree >= 0.995, f"saliency block masks card vs CPU agree on {agree:.4%} (>= 99.5%)")

    c_blur, c_blv = blurred[:2, rows_, cols], blur_lv[:2, brows, bcols]
    noise = torch.randn(c_blur.shape, generator=torch.Generator().manual_seed(SEED))
    net = diffusion.net
    cpu_net, _ = resolve_deblur_backend("diffusion", base, device="cpu")
    r_card = net.restore_adaptive(c_blur, c_blv, B, noise=noise.cuda()).cpu()
    r_cpu = cpu_net.net.restore_adaptive(c_blur.cpu(), c_blv.cpu(), B, noise=noise)
    err = (r_card - r_cpu).abs()
    change = float((r_cpu - c_blur.cpu().float()).abs().mean())
    apart["diffusion restore_adaptive (bf16)"] = {
        "max_abs_grey": float(err.max()), "mean_abs_grey": float(err.mean()),
        "cpu_mean_change_of_input_grey": change}
    # an identity restorer's mean error would be the change itself
    check(float(err.max()) <= DIFFUSION_MAX_GREY and float(err.mean()) <= DIFFUSION_MEAN_GREY
          < change,
          f"diffusion card vs CPU: {apart['diffusion restore_adaptive (bf16)']} (max <= "
          f"{DIFFUSION_MAX_GREY}, mean <= {DIFFUSION_MEAN_GREY} grey levels, and the restore "
          f"moves the input by more than {DIFFUSION_MEAN_GREY} on average)")

    c_down, c_dlv = down[:2, rows_, cols], down_lv[:2, brows, bcols]
    large_cpu, _ = resolve_sr_backend("srnet_large", base, device="cpu")
    g_card = sr["srnet_large"](c_down, c_dlv, B).cpu()
    g_cpu = large_cpu(c_down.cpu(), c_dlv.cpu(), B)
    ref = clip[:2, rows_, cols].cpu()
    p_err = float((masked_psnr(ref, g_card) - masked_psnr(ref, g_cpu)).abs().max())
    apart["srnet_large restore"] = {"max_lsb": int((g_card.int() - g_cpu.int()).abs().max()),
                                    "psnr_apart_db": p_err}
    check(p_err <= 0.05, f"srnet_large card vs CPU: PSNR apart {p_err} dB (tol 0.05)")
    print(f"[backends] card vs CPU on a {N}x{ch}x{cw} crop at ({y0}, {x0}) (diffusion and "
          f"srnet_large: its first 2 frames): " + json.dumps(apart))
    return launches


def _argv_lines(fake):
    """The argv chains the codec shim recorded so far."""
    import os

    with open(os.path.join(fake, "argv.jsonl")) as f:
        return [json.loads(line) for line in f]


def _qpfile_apart(a_text, b_text):
    """(lines, values differing, largest |difference|) of two qpfiles, after
    checking they have the same lines and tokens."""
    a_lines, b_lines = a_text.splitlines(), b_text.splitlines()
    check(len(a_lines) == len(b_lines), f"qpfile lines {len(a_lines)} vs {len(b_lines)}")
    values, lines, worst = 0, 0, 0.0
    for la, lb in zip(a_lines, b_lines):
        ta, tb = la.split(" "), lb.split(" ")
        check(ta[:3] == tb[:3] and len(ta) == len(tb), "qpfile line heads or lengths differ")
        diff = 0
        for x, y in zip(ta[3:], tb[3:]):
            (kx, vx), (ky, vy) = x.rsplit(",", 1), y.rsplit(",", 1)
            check(kx == ky, f"qpfile cells {x} vs {y}")
            worst = max(worst, abs(float(vx) - float(vy)))
            diff += vx != vy
        values += diff
        lines += diff > 0
    return lines, values, worst


def phase_external(smi_line):
    """The SR tiers of this slice and the external encoders at full width:
    run_elvis through x265 with 'srnet' and 'srnet_ensemble' beside the
    generic slot, under the codec shim (set here and unset when done); the
    argv chain, the qpfile and its card-vs-CPU regrid; kvazaar and SVT-AV1
    through their pipeline codecs with the rate model's QP and CRF, their
    ROI files held to the CPU; then the RRDB tier and the ensemble alone
    (CUDA events, peak memory) and on a centre crop held to the CPU.
    Returns the run's launches."""
    import os
    import tempfile

    import numpy as np

    from elvis_tpu_torch.codec import roi
    from elvis_tpu_torch.codec.dispatch import _RateModel, make_pipeline_codec
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.metrics import masked_psnr
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.pipeline.run import _apply_framewise, _carry_tiling
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    which = subprocess.run(["which", *EXTERNAL_BINARIES], capture_output=True, text=True)
    print(f"[external] which {' '.join(EXTERNAL_BINARIES)}: rc {which.returncode}, found "
          f"{which.stdout.split() or 'none'}")
    fake = tempfile.mkdtemp(prefix="elvis_fake_codecs_")
    os.environ["ELVIS_TPU_FAKE_CODECS"] = fake
    print(f"[external] ELVIS_TPU_FAKE_CODECS={fake} set for this phase: every external encode "
          "records its argv and the adapter stashes its input losslessly, so the rows' bits "
          "below are the stash's size, not an encoder's")
    try:
        with tempfile.TemporaryDirectory() as exp:
            cfg = ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30", width=W,
                              height=H, experiment_dir=exp, **EXTERNAL_NAMES)
            torch.cuda.synchronize()
            stats = {}
            LAUNCHES.clear()
            t0 = time.perf_counter()
            run = run_elvis(cfg, device="cuda", stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            argv = _argv_lines(fake)
            qpfiles = sorted(f for f in os.listdir(os.path.join(exp, "codec"))
                             if f.endswith(".qpfile"))
            check(len(qpfiles) == 1, f"qpfiles written: {qpfiles}")
            with open(os.path.join(exp, "codec", qpfiles[0])) as f:
                run_qpfile = f.read()
        times, peaks = run["execution_times_seconds"], stats["stage_peak_bytes"]
        print(f"[external] run_elvis with {json.dumps(EXTERNAL_NAMES)}, {N} frames {W}x{H}, "
              f"{smi_line}: {wall:.2f} s wall; peak max_memory_allocated {max(peaks.values())} "
              "bytes")
        print("[external] execution_times_seconds: " + json.dumps(times))
        print("[external] peak max_memory_allocated by stage, bytes: " + json.dumps(peaks))
        print("[external] backends: " + json.dumps(run["parameters"]["derived"]["backends"]))
        print(f"[external] kernel launches in the run: {json.dumps(launches)}")
        check(run["parameters"]["derived"]["codec"] == "x265", "the run did not use x265")
        check(launches.get("block_transform", 0) == 4,
              "one transform launch per degrade or classical stage (downsample, blur, Lanczos, "
              f"unsharp): {launches}")
        # the argv chain: 5 encodes x 2 passes, the qpfile on the ROI encode's pass 2 only
        check(len(argv) == 10 and all(a[0] == "ffmpeg" for a in argv), f"argv lines {len(argv)}")
        params = [a[a.index("-x265-params") + 1] for a in argv]
        with_qp = [i for i, x in enumerate(params) if "qpfile=" in x]
        check(with_qp == [5] and "ctu=16" in params[5] and "ctu=16" in params[4],
              f"qpfile / ctu in the x265-params: {params}")
        check(all(a[a.index("-preset") + 1] == "slow" for a in argv), "the preset is not slow")
        check(all("pass=1" in params[i] and "pass=2" in params[i + 1] for i in range(0, 10, 2)),
              "passes out of order")
        print(f"[external] argv chain: {len(argv)} lines (5 encodes x 2 passes), the qpfile on "
              f"line 6 only: {params[5][:60]}...")
        rows = _rows(run)
        check(rows == list(EXTERNAL_ROWS), f"rows {rows}")
        for row in rows:
            r = run[row]
            for region in ("foreground", "background"):
                for key in ("psnr_mean", "ssim_mean", "mse_mean", "lpips_mean", "fvmd"):
                    check(np.isfinite(r[region][key]), f"{row} {region} {key} = {r[region][key]}")
            fg, bg = r["foreground"], r["background"]
            print(f"[external] {row:<26} {r['bitrate_mbps'] * 1e6:11.0f} bit/s (stash); fg/bg "
                  f"PSNR {fg['psnr_mean']:.4f} / {bg['psnr_mean']:.4f} dB, SSIM "
                  f"{fg['ssim_mean']:.5f} / {bg['ssim_mean']:.5f}, LPIPS {fg['lpips_mean']:.5f}"
                  f" / {bg['lpips_mean']:.5f}, FVMD {fg['fvmd']:.4f} / {bg['fvmd']:.4f}")

        # the qpfile: 8 lines of 68x120 CTUs; the card's regrid against the
        # CPU's on the same scores
        clip = make_clip(torch.device("cuda"))
        base = ElvisConfig()
        scores, _ = score(clip, base)
        rows_ctu, cols_ctu = math.ceil(H / 16), math.ceil(W / 16)
        lines = run_qpfile.splitlines()
        check(len(lines) == N and all(len(x.split(" ")) == 3 + rows_ctu * cols_ctu
                                      for x in lines),
              f"qpfile: {len(lines)} lines, not {N} of {rows_ctu}x{cols_ctu} CTUs")
        sc = scores.cpu().numpy()
        with tempfile.TemporaryDirectory() as d:
            texts = {}
            for where in ("cuda", "cpu"):
                check(roi.write_x265_qpfile(f"{d}/{where}", sc, B, W, H, device=where) == 16,
                      "the CTU is not 16")
                with open(f"{d}/{where}") as f:
                    texts[where] = f.read()
        q_lines, q_values, q_worst = _qpfile_apart(texts["cuda"], texts["cpu"])
        print(f"[external] qpfile {N} lines x {rows_ctu}x{cols_ctu} CTUs; regrid on the card vs "
              f"the CPU on the same scores: {q_lines} lines and {q_values} values differ, "
              f"largest {q_worst:.6f} (tol 1e-4 a value)")
        check(q_worst <= 1e-4 + 1e-9, f"qpfile values apart by {q_worst}")

        # kvazaar and SVT-AV1 through their pipeline codecs on the clip
        importance = 1.0 - sc
        target = run["target_bitrate_bps"]
        ext = {}
        with tempfile.TemporaryDirectory() as d:
            for name in ("kvazaar", "svtav1"):
                codec = make_pipeline_codec(name, f"{d}/{name}", W, H, device="cuda")
                before = len(_argv_lines(fake))
                t0 = time.perf_counter()
                stream = codec.encode_roi(clip, removability=sc, importance=importance,
                                          block_size=B, roi_qp_range=15, target_bitrate=target,
                                          framerate=30.0, gop=30)
                enc_s = time.perf_counter() - t0
                check(torch.equal(codec.decode(stream), clip), f"{name}: the stash round trip")
                chain = _argv_lines(fake)[before:]
                pick = (codec._rate.hevc_qp if name == "kvazaar" else codec._rate.av1_crf)
                q = pick(clip, target, 30.0)
                flag = "-q" if name == "kvazaar" else "--crf"
                check(len(chain) == (3 if name == "kvazaar" else 2)
                      and chain[0][chain[0].index(flag) + 1] == str(q),
                      f"{name} argv chain: {chain}")
                files = {}
                for where in ("cuda", "cpu"):
                    path = f"{d}/{name}_{where}.roi"
                    if name == "kvazaar":
                        roi.write_kvazaar_roi(path, importance, base_qp=q,
                                              qp_range=codec.qp_range)
                        with open(path, "rb") as f:
                            files[where] = f.read()
                    else:
                        roi.write_svtav1_roi(path, importance, base_crf=q,
                                             qp_range=codec.qp_range, width=W, height=H,
                                             device=where)
                        with open(path) as f:
                            files[where] = [int(v) for v in f.read().split()]
                if name == "kvazaar":
                    apart_roi = int(files["cuda"] != files["cpu"])
                    check(apart_roi == 0, "kvazaar ROI file differs between card and CPU")
                else:
                    apart_roi = max(abs(a - b) for a, b in zip(files["cuda"], files["cpu"]))
                    check(len(files["cuda"]) == len(files["cpu"])
                          and apart_roi <= 2 * codec.qp_range // 7 + 1,
                          f"SVT-AV1 ROI offsets apart by {apart_roi} (one segment)")
                ext[name] = {"qp_or_crf": q, "encode_roi_s": round(enc_s, 3),
                             "argv_lines": len(chain), "roi_file_apart": apart_roi}
        # the rate model's probe on a centre crop, card against CPU
        ch, cw = CROP
        y0 = (H // 2 - ch // 2) // (2 * B) * (2 * B)
        x0 = (W // 2 - cw // 2) // (2 * B) * (2 * B)
        crop = clip[:, y0:y0 + ch, x0:x0 + cw]
        small_target = int(target * ch * cw / (H * W))
        qp_card = _RateModel("cuda").hevc_qp(crop, small_target, 30.0)
        qp_cpu = _RateModel("cpu").hevc_qp(crop.cpu(), small_target, 30.0)
        ext["rate model on the crop"] = {"qp_card": qp_card, "qp_cpu": qp_cpu}
        check(abs(qp_card - qp_cpu) <= 1, f"rate model QP card {qp_card} vs CPU {qp_cpu}")
        print(f"[external] kvazaar / SVT-AV1 encode_roi at {W}x{H}, target {target} bit/s "
              f"(QP / CRF from the NVC probe on the card; ROI files on the card vs the CPU): "
              + json.dumps(ext))
    finally:
        del os.environ["ELVIS_TPU_FAKE_CODECS"]
        print("[external] ELVIS_TPU_FAKE_CODECS unset")

    # the RRDB tier and the ensemble alone on the main path's degraded clip
    down, down_lv = adaptive_downsample(clip, scores, B)
    sr = {n: resolve_sr_backend(n, base, device="cuda") for n in ("srnet", "srnet_ensemble")}
    alone = {}
    for n, (fn, prov) in sr.items():
        ms, peak = _timed_with_peak(
            lambda fn=fn: _apply_framewise(_carry_tiling(lambda a, b: fn(a, b, B), fn),
                                           down, down_lv))
        alone[n] = {"ms": round(ms, 3), "peak_bytes": peak, "provenance": prov}
    print(f"[external] {N}x{H}x{W}, each alone as stage 9 drives it (CUDA events, mean of 3 "
          f"after one warm-up; peak max_memory_allocated above what was held), {smi_line}: "
          + json.dumps(alone))
    ch, cw = SR_CROP
    y0 = (H // 2 - ch // 2) // (2 * B) * (2 * B)
    x0 = (W // 2 - cw // 2) // (2 * B) * (2 * B)
    c_down = down[:2, y0:y0 + ch, x0:x0 + cw]
    c_lv = down_lv[:2, y0 // B:(y0 + ch) // B, x0 // B:(x0 + cw) // B]
    ref = clip[:2, y0:y0 + ch, x0:x0 + cw].cpu()
    apart = {}
    for n, (fn, _) in sr.items():
        cpu_fn, _ = resolve_sr_backend(n, base, device="cpu")
        g_card = fn(c_down, c_lv, B).cpu()
        g_cpu = cpu_fn(c_down.cpu(), c_lv.cpu(), B)
        lsb = (g_card.int() - g_cpu.int()).abs()
        p_err = float((masked_psnr(ref, g_card) - masked_psnr(ref, g_cpu)).abs().max())
        apart[n] = {"max_lsb": int(lsb.max()), "mean_lsb": float(lsb.float().mean()),
                    "psnr_apart_db": p_err}
        check(int(lsb.max()) <= 1 and float(lsb.float().mean()) <= 0.1 and p_err <= 0.05,
              f"{n} card vs CPU: {apart[n]} (1 LSB, 0.1 LSB mean, 0.05 dB)")
    print(f"[external] card vs CPU on a 2x{ch}x{cw} crop at ({y0}, {x0}): " + json.dumps(apart))
    return launches


def _presley_rows_apart(a, b, skip=()):
    """Largest difference of each metric over two run_presley results' rows
    (but ``skip``): relative for the bytes and the MSE, absolute for the
    rest."""
    worst = {}
    for row, rb in b["methods"].items():
        if row in skip:
            continue
        ra = a["methods"][row]
        if "size_bytes" in rb:
            worst["bytes_rel"] = max(worst.get("bytes_rel", 0.0),
                                     abs(ra["size_bytes"] - rb["size_bytes"]) / rb["size_bytes"])
        for key, vb in rb["metrics"].items():
            d = abs(ra["metrics"][key] - vb)
            worst[key] = max(worst.get(key, 0.0), d / vb if key == "mse" else d)
    return worst


def phase_presley(smi_line):
    """The PRESLEY sweep as users start it (``python -m
    elvis_tpu_torch.presley``): ``run_presley`` at ``PresleyConfig()``'s
    defaults on the card, every row ``ok`` with finite metrics, the JSON
    written, each row's time and the transform launches; then a 6x96x64 run
    on the card held to one on the CPU. Returns the run's launches."""
    import os
    import tempfile

    import numpy as np

    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.presley import PresleyConfig, run_presley

    with tempfile.TemporaryDirectory() as out:
        cfg = PresleyConfig(output_dir=out)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res = run_presley(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(os.path.isfile(os.path.join(out, "performance_metrics.json")),
              "run_presley wrote no performance_metrics.json")
        with open(os.path.join(out, "performance_metrics.json")) as f:
            written = json.load(f)
    methods = res["methods"]
    want = 14 + 3 * (len(cfg.shrink_methods) - 1)
    check(len(methods) == want and list(written["methods"]) == list(methods),
          f"{len(methods)} rows, not {want}")
    for row, r in methods.items():
        check(r["status"] == "ok", f"{row}: status {r['status']} {r.get('error', '')}")
        check(all(np.isfinite(v) for v in r["metrics"].values()), f"{row}: {r['metrics']}")
    print(f"[presley] run_presley at PresleyConfig() ({cfg.width}x{cfg.height}, "
          f"{cfg.max_frames} frames, block {cfg.block_size}, shrink {cfg.shrink_methods}), "
          f"{smi_line}: {wall:.2f} s wall, {len(methods)} rows all ok; peak "
          f"max_memory_allocated {peak} bytes")
    for row, r in methods.items():
        m = r["metrics"]
        print(f"[presley] {row:<32} {r['seconds'] * 1e3:9.2f} ms ({r['fps']:.1f} frames/s); "
              f"{r.get('size_bytes', 0):8d} bytes; PSNR {m['psnr']:.4f} (fg {m['fg_psnr']:.4f}"
              f", bg {m['bg_psnr']:.4f}) dB, SSIM {m['ssim']:.5f}, MSE {m['mse']:.3f}")
    print(f"[presley] kernel launches in the run: {json.dumps(launches)}")
    # where the rest of the wall goes: the parts outside the rows, each once
    from elvis_tpu_torch.codec import QUALITY_PRESETS, NvcCodec
    from elvis_tpu_torch.pipeline.io import load_clip, save_frames_png

    parts = {}
    t0 = time.perf_counter()
    frames_np, fps = load_clip(cfg.reference_video, cfg.width, cfg.height, None, device="cuda")
    parts["load_clip (synthetic, host)"] = time.perf_counter() - t0
    clip = torch.as_tensor(frames_np[:cfg.max_frames], device="cuda")
    codec = NvcCodec("cuda")
    t0 = time.perf_counter()
    stream = codec.encode(clip, qp=QUALITY_PRESETS[cfg.quality]["nvc_qp"], framerate=fps)
    parts["one NVC encode of the clip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec.decode(stream)
    torch.cuda.synchronize()
    parts["one NVC decode"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_frames_png(clip, d)
        parts["one row's PNG frames (save_intermediate)"] = time.perf_counter() - t0
    rows_s = sum(r["seconds"] for r in methods.values())
    print(f"[presley] outside the rows ({rows_s:.2f} s of restorers timed in them), each part "
          f"once, host clock: " + json.dumps({k: round(v, 3) for k, v in parts.items()})
          + f"; the run makes {5 + len(cfg.shrink_methods)} encodes and decodes and "
          f"{len(methods)} rows of PNGs")
    check(launches.get("block_transform", 0) == PRESLEY_TRANSFORM_LAUNCHES,
          f"{PRESLEY_TRANSFORM_LAUNCHES} transform launches (three degrades, 'lanczos', "
          f"'lanczos_tb', scale-Lanczos, unsharp): {launches}")

    # 6x96x64 on the card and on the CPU: the pipeline's row tolerances; the
    # diffusion row draws its noise from each device's generator, so it is
    # held to twice the CPU's own range over three seeds where that is larger
    small = dict(reference_video="synthetic://moving?frames=6", width=96, height=64,
                 max_frames=6, save_intermediate=False)
    with tempfile.TemporaryDirectory() as out:
        card = run_presley(PresleyConfig(output_dir=f"{out}/card", **small), device="cuda")
        cpu = {seed: run_presley(PresleyConfig(output_dir=f"{out}/cpu{seed}",
                                               instantir_seed=seed, **small), device="cpu")
               for seed in (42, 43, 44)}
    diff_row = "blur_instantir_adaptive"
    check(list(card["methods"]) == list(cpu[42]["methods"]), "small run rows")
    worst = _presley_rows_apart(card, cpu[42], skip=(diff_row,))
    seeds = [cpu[s]["methods"][diff_row]["metrics"] for s in cpu]
    spread = {k: max(m[k] for m in seeds) - min(m[k] for m in seeds) for k in seeds[0]}
    d_card = card["methods"][diff_row]["metrics"]
    d_worst = {k: abs(d_card[k] - seeds[0][k]) for k in d_card}
    print(f"[presley] run_presley 6x96x64, card vs CPU, largest difference over the rows but "
          f"the diffusion row: {json.dumps(worst)} (tol bytes 1%, PSNR 0.1 dB, SSIM 2e-3, MSE "
          f"1%); the diffusion row {json.dumps(d_worst)}, the CPU's range over seeds 42-44 "
          f"{json.dumps(spread)}")
    check(all(r["status"] == "ok" for r in card["methods"].values()), "small card run rows")
    tol = {"psnr": 0.1, "fg_psnr": 0.1, "bg_psnr": 0.1, "ssim": 2e-3, "mse": 0.01}
    check(worst["bytes_rel"] <= 0.01 and all(worst[k] <= t for k, t in tol.items()),
          f"card and CPU runs differ: {worst}")
    check(all(d_worst[k] <= max(t * (seeds[0][k] if k == "mse" else 1), 2 * spread[k])
              for k, t in tol.items()), f"the diffusion row differs: {d_worst}")
    return launches


def _logical_devices(k):
    """The port's device list replaced by ``k`` logical shards of the card
    (``parallel.mesh.devices``, the one function the mesh code asks);
    returns the undo."""
    from elvis_tpu_torch.parallel import mesh as pmesh

    real = pmesh.devices
    pmesh.devices = lambda device_type="cuda": [torch.device("cuda:0")] * k
    return lambda: setattr(pmesh, "devices", real)


def _tall_clip(n, h, w, device):
    """make_clip's moving gradients at another size, uint8 (N, H, W, 3)."""
    t = torch.arange(n, device=device, dtype=torch.float32)[:, None, None]
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    clip = torch.clamp(128 + 80 * torch.sin(2 * math.pi * (xx + 40 * t) / 300)
                       * torch.cos(2 * math.pi * yy / 200), 0, 255)
    gen = torch.Generator(device=device).manual_seed(SEED)
    noise = torch.randn((n, h, w, 3), generator=gen, device=device) * 2.0
    return torch.clamp(torch.round(clip[..., None] + noise), 0, 255).to(torch.uint8)


def _u8_apart(a, b):
    """(max |a - b| in LSB, share of pixels that differ)."""
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def phase_parallel(smi_line, shrunk_stream, removal, default_run):
    """The parallel layer at full width on logical shards of the one card:
    the student's restore in height tiles at 2160p, the temporal fill with
    halo frames, run_elvis over a 2-shard data mesh, and run_elvis with a
    per-stage device list and a spatial axis that one card cannot form.
    Returns the sharded run's launches."""
    import tempfile

    from elvis_tpu_torch.codec.nvc.codec import decode
    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.degrade.removal import stretch_frames
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.ops.motion import motion_field_from_hint
    from elvis_tpu_torch.parallel import make_mesh, spatial_tile_map_blocks, temporal_map_overlap
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal

    dev = torch.device("cuda")
    cfg = ElvisConfig()
    tn, th, tw = TALL
    check(th >= cfg.spatial_tile_threshold, f"{th} rows do not reach the spatial threshold")
    clip = _tall_clip(tn, th, tw, dev)
    degraded, levels = adaptive_downsample(clip, score(clip, cfg)[0], B)
    restore, prov = resolve_sr_backend("realesrgan", cfg, device=dev)
    undo = _logical_devices(TALL_TILES)
    try:
        mesh = make_mesh((("data", 1), ("spatial", TALL_TILES)), device_type="cuda")
    finally:
        undo()

    def tiled(halo):
        return spatial_tile_map_blocks(lambda f, lv: restore(f, lv, B), degraded, levels, mesh,
                                       halo, B, data_axis="data")

    whole_ms, whole_peak = _timed_with_peak(lambda: restore(degraded, levels, B), iters=2)
    tiled_ms, tiled_peak = _timed_with_peak(lambda: tiled(TALL_HALO), iters=2)
    whole = restore(degraded, levels, B)
    mx, share = _u8_apart(tiled(TALL_HALO), whole)
    mx_short, share_short = _u8_apart(tiled(SHORT_HALO), whole)
    print(f"[parallel] {prov} on {tn}x{th}x{tw}, data 1 x spatial {TALL_TILES} logical mesh "
          f"on cuda:0, "
          f"halo {TALL_HALO}, {smi_line}: tiles {tiled_ms:.2f} ms (peak {tiled_peak} bytes), "
          f"whole frames {whole_ms:.2f} ms (peak {whole_peak} bytes); tiles against whole: "
          f"max {mx} LSB, {share:.2e} of pixels differ (bound 1 LSB on at most "
          f"{SHARD_U8_SHARE:.0e}); with halo {SHORT_HALO}: max {mx_short} LSB, "
          f"{share_short:.2e} of pixels differ (not held)")
    check(mx <= 1 and share <= SHARD_U8_SHARE, "the height-tiled restore differs from the whole")
    del clip, degraded, levels, whole

    # the temporal fill with halo frames on the phase 6 clip (window 1,
    # overlap 2: every shard of 2 and 4 holds at least the overlap)
    masks, gmv, mdev = removal
    mask = torch.as_tensor(masks.astype("int8"), device=dev)
    decoded, _ = decode(shrunk_stream, device=dev)
    stretched = stretch_frames(decoded, mask, B)
    field = motion_field_from_hint(torch.as_tensor(gmv, device=dev),
                                   torch.as_tensor(mdev, device=dev), H // B, W // B)
    hole = mask.bool().repeat_interleave(B, 1).repeat_interleave(B, 2)
    fills = {}
    for label, arrays, call, zero_edge in (
            ("motion hint", (stretched, mask, field),
             lambda f, m, mv: restore_removal_temporal(f, m, B, window=1, motion_field=mv),
             (False, False, True)),
            ("estimated motion", (stretched, mask),
             lambda f, m: restore_removal_temporal(f, m, B, window=1), ())):
        whole = call(*arrays)
        for k in (2, 4):
            undo = _logical_devices(k)
            try:
                mesh = make_mesh(device_type="cuda")
            finally:
                undo()
            run = lambda: temporal_map_overlap(call, arrays, mesh, overlap=2,  # noqa: E731
                                               zero_edge=zero_edge)
            ms, peak = _timed_with_peak(run)
            got = run()
            d = (got[hole].int() - whole[hole].int()).abs()
            known = bool(torch.equal(got[~hole], whole[~hole]))
            within = float((d <= 1).float().mean())
            by_frame = (got.int() - whole.int()).abs().amax(dim=(1, 2, 3))
            fills[f"{label}, {k} shards"] = {"ms": round(ms, 3), "peak_bytes": peak,
                                             "known_bit_equal": known,
                                             "hole_within_1_lsb": within,
                                             "hole_max_lsb": int(d.max()),
                                             "max_lsb_by_frame": by_frame.tolist()}
            check(known and within >= 0.995 and int(by_frame[-1]) <= 1,
                  f"temporal fill over {k} shards ({label}) against unsharded: "
                  f"{fills[f'{label}, {k} shards']}")
        fills[f"{label}, unsharded"] = {"ms": round(_timed_with_peak(lambda: call(*arrays))[0],
                                                    3)}
    print(f"[parallel] temporal fill (window 1, overlap 2) on the phase 6 clip, {N}x{H}x{W}, "
          f"{smi_line}: " + json.dumps(fills) + " (known pixels bit-equal, at least 99.5% of "
          "hole pixels within 1 LSB: the fill's scatter adds with float atomics; the last "
          "frame within 1 LSB: the hint's field has a zero-motion halo edge)")
    del decoded, stretched, field

    # run_elvis, the default config, over a logical 2-shard data mesh
    tol = {"bitrate_rel": 0.01, "psnr_mean": 0.1, "ssim_mean": 2e-3, "lpips_mean": 1e-3}
    undo = _logical_devices(2)
    try:
        with tempfile.TemporaryDirectory() as exp:
            torch.cuda.synchronize()
            stats = {}
            LAUNCHES.clear()
            t0 = time.perf_counter()
            sharded = run_elvis(ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30",
                                            width=W, height=H, experiment_dir=exp),
                                device="cuda", stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
    finally:
        undo()
    apart = _rows_apart(sharded, default_run)
    print(f"[parallel] run_elvis over a logical 2-shard data mesh, {N}x{H}x{W}, {smi_line}: "
          f"{wall:.2f} s wall, peak max_memory_allocated "
          f"{max(stats['stage_peak_bytes'].values(), default=0)} bytes; execution_times_seconds "
          f"{json.dumps(sharded['execution_times_seconds'])}; against phase 6's unsharded run: "
          f"{json.dumps(apart)} (tol {json.dumps(tol)}); transform launches "
          f"{json.dumps(launches)}")
    check(_rows(sharded) == list(PIPELINE_ROWS), f"sharded rows {_rows(sharded)}")
    check(all(apart[k] <= v for k, v in tol.items()), f"the sharded run's rows differ: {apart}")
    check(launches.get("block_transform", 0) == PARALLEL_TRANSFORM_LAUNCHES,
          f"{PARALLEL_TRANSFORM_LAUNCHES} transform launches (downsample, blur, and Lanczos and "
          f"unsharp on each of 2 shards): {launches}")

    # a one-device stage list and a spatial axis one card cannot form: no mesh
    with tempfile.TemporaryDirectory() as exp:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        single = run_elvis(ElvisConfig(reference_video=f"synthetic://moving?frames={N}&fps=30",
                                       width=W, height=H, experiment_dir=exp,
                                       realesrgan_devices=[0], spatial_devices=2),
                           device="cuda")
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches1 = dict(LAUNCHES)
    apart1 = _rows_apart(single, default_run)
    print(f"[parallel] run_elvis with realesrgan_devices=[0], spatial_devices=2 on the one card: "
          f"{wall1:.2f} s wall; against the default run: {json.dumps(apart1)}; transform "
          f"launches {json.dumps(launches1)}")
    check(_rows(single) == list(PIPELINE_ROWS) and all(apart1[k] <= v for k, v in tol.items()),
          f"the device-list run's rows differ from the default run's: {apart1}")
    check(launches1.get("block_transform", 0) == 4, f"no mesh: 4 transform launches, {launches1}")
    return launches


def nondeterministic_ops(fn):
    """Run ``fn`` once under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` and return the distinct warnings torch gives for the
    ops it has no deterministic version of (the setting is put back)."""
    import warnings

    prev = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(prev)
    return sorted({str(w.message).splitlines()[0] for w in caught
                   if "deterministic" in str(w.message)})


def phase_train(smi_line):
    """The trainers on the card: ``train_srnet_student`` at the shipped
    architecture with the three teachers, its checkpoint through the SR
    backend, the sharded steps against the unsharded one, a step on the
    card against the CPU, then ``deblur`` and ``srnet_4k``. Returns the
    transform launches of the student's run."""
    import tempfile

    from elvis_tpu_torch.degrade import adaptive_downsample
    from elvis_tpu_torch.device import full_fp32
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.models import SRNetCompact
    from elvis_tpu_torch.models.io import load_deblur, load_srnet, weights_path
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.parallel import make_mesh
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend
    from elvis_tpu_torch.restore.progressive import progressive_restore
    from elvis_tpu_torch.train import trainer as ttrainer
    from elvis_tpu_torch.train.cli import MAX_LEVEL, train_deblur, train_srnet_4k, \
        train_srnet_student
    from elvis_tpu_torch.train.data import natural_frames

    dev = torch.device("cuda")
    warm = min(100, TRAIN_STEPS // 10 + 1)
    snaps = {}
    real_step = ttrainer.Trainer.step

    def step_and_snap(self, batch):  # the parameters right after warm-up
        loss = real_step(self, batch)
        if self.state.step == warm:
            snaps["warm"] = {k: v.clone() for k, v in self.params().items()}
        return loss

    # a held-out batch: the loop's ground-truth loss before and after
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    held_clean = natural_frames(gen, STUDENT["batch"], STUDENT["patch"], STUDENT["patch"])
    side = STUDENT["patch"] // B
    held_deg, held_lv = adaptive_downsample(
        held_clean, torch.rand((STUDENT["batch"], side, side), generator=gen, device=dev), B)

    def held_loss(model, params):
        up = lambda f: torch.func.functional_call(model, params, (f,))  # noqa: E731
        with torch.no_grad():
            out = progressive_restore(held_deg, held_lv, B, upsample_fn=up, max_level=MAX_LEVEL)
        return float(torch.mean((out - held_clean) ** 2) / 255.0**2)

    ttrainer.Trainer.step = step_and_snap
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            tr = train_srnet_student(TRAIN_STEPS, ckpt, lr=TRAIN_LR, photo_fraction=0.0,
                                     device=dev, log_every=10, **STUDENT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - held
            launches = dict(LAUNCHES)
            path = f"{ckpt}/srnet_student.npz"
            meta = json.load(open(f"{ckpt}/srnet_student.meta.json"))
            fn, prov = resolve_sr_backend("srnet_student",
                                          ElvisConfig(srnet_params_path=path), device=dev)
            via_backend = fn(held_deg, held_lv, B)
            with torch.no_grad():
                via_module = progressive_restore(held_deg, held_lv, B,
                                                 upsample_fn=srnet_upsample_fn(tr.model))
    finally:
        ttrainer.Trainer.step = real_step
    losses = tr.losses
    ms = sorted(tr.step_ms[1:])
    first_loss = held_loss(tr.model, snaps["warm"])
    last_loss = held_loss(tr.model, tr.params())
    curve = {f"{a}-{b - 1}": round(sum(losses[a:b]) / (b - a), 6)
             for a, b in ((0, warm), (warm, warm + 10), (TRAIN_STEPS - 10, TRAIN_STEPS))}
    print(f"[train] train_srnet_student {STUDENT}, three teachers {meta['teachers']}, "
          f"photo_fraction 0, {TRAIN_STEPS} steps at lr {TRAIN_LR}, {smi_line}: {wall:.2f} s "
          f"wall (teachers' "
          f"load included), step ms by CUDA events: first {tr.step_ms[0]:.2f}, median "
          f"{ms[len(ms) // 2]:.2f}, min {ms[0]:.2f}, max {ms[-1]:.2f}; peak max_memory_allocated "
          f"{peak} bytes; transform launches {json.dumps(launches)}")
    print(f"[train] loss curve (mean by steps): {json.dumps(curve)}; every step: "
          + json.dumps([round(x, 6) for x in losses]))
    print(f"[train] held-out batch ({STUDENT['batch']} natural patches), ground-truth loss "
          f"after warm-up (step {warm}) {first_loss:.6f}, at the end {last_loss:.6f}")
    check(all(math.isfinite(x) for x in losses), "a non-finite training loss")
    check(last_loss < first_loss, "the held-out loss did not fall after warm-up")
    check(launches.get("block_transform", 0) == TRAIN_STEPS,
          f"one transform launch (the batch's adaptive downsample) per step: {launches}")
    print(f"[train] checkpoint through resolve_sr_backend: {prov}")
    check(prov == f"progressive_neural[srnet_student:{path}]", f"provenance {prov}")
    check(torch.equal(via_backend, via_module), "the loaded student's restore differs from the "
                                                "trained module's")

    # the sharded steps against the unsharded step: float32 copies of the
    # trained student, full float32, constant learning rate, two steps
    batches = []
    for _ in range(2):
        clean = natural_frames(gen, STUDENT["batch"], STUDENT["patch"], STUDENT["patch"])
        deg, lv = adaptive_downsample(
            clean, torch.rand((STUDENT["batch"], side, side), generator=gen, device=dev), B)
        batches.append((clean, deg, lv))

    def sr_steps(mesh, dtype, batches_, device, state):
        model = SRNetCompact(STUDENT["features"], STUDENT["num_convs"], dtype=dtype)
        model.load_state_dict(state)
        model.to(device)

        def loss_fn(p, data):
            up = lambda f: torch.func.functional_call(model, p, (f,))  # noqa: E731
            out = progressive_restore(data[1], data[2], B, upsample_fn=up, max_level=MAX_LEVEL)
            return torch.mean((out - data[0]) ** 2) / 255.0**2

        t = ttrainer.Trainer(loss_fn, model, mesh=mesh, learning_rate=STEP_LR, device=device)
        step_losses = [float(t.step(tuple(x.to(device) for x in b))) for b in batches_]
        return t.params(torch.device("cpu")), step_losses

    trained = tr.model.state_dict()
    start = {k: v.cpu() for k, v in tr.params().items()}

    def apart(got, want, start=start):
        """Adam moves a weight by up to the learning rate whatever its
        gradient's size, so a near-zero gradient's rounding (cuDNN picks its
        algorithms by batch) can move one weight apart: per tensor, the mean
        distance against the mean move, and the largest distance."""
        return {"mean_over_move": max(float((got[n] - want[n]).abs().mean()) / max(
                    float((want[n] - start[n]).abs().mean()), 1e-12) for n in want),
                "max_param_apart": max(float((got[n] - want[n]).abs().max()) for n in want)}

    # cuDNN's float32 backward picks nondeterministic algorithms by default:
    # the comparison runs with deterministic ones, then the settings return
    shard_apart = {}
    cudnn = torch.backends.cudnn
    prev_cudnn = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with full_fp32():
            one, one_losses = sr_steps(make_mesh(devices=[0], device_type="cuda"),
                                       torch.float32, batches, dev, trained)
            for label, k, axes in (("data 2", 2, (("data", 2),)),
                                   ("data 2 x tensor 2", 4, (("data", 2), ("tensor", 2)))):
                undo = _logical_devices(k)
                try:
                    mesh = make_mesh(axes, device_type="cuda")
                finally:
                    undo()
                got, got_losses = sr_steps(mesh, torch.float32, batches, dev, trained)
                shard_apart[label] = dict(apart(got, one), loss_rel_apart=max(
                    abs(a - b) / b for a, b in zip(got_losses, one_losses)))
            again, _ = sr_steps(make_mesh(devices=[0], device_type="cuda"), torch.float32,
                                batches, dev, trained)
            shard_apart["one device again"] = again_apart = apart(again, one)
            repeats = again_apart["max_param_apart"] == 0 and again_apart["mean_over_move"] == 0
            if not repeats:  # name the ops that torch knows to be nondeterministic
                named = nondeterministic_ops(lambda: sr_steps(
                    make_mesh(devices=[0], device_type="cuda"), torch.float32, batches, dev,
                    trained))
                print(f"[train] the unsharded float32 step does not repeat bit for bit; under "
                      f"torch.use_deterministic_algorithms(True, warn_only=True) torch names: "
                      f"{json.dumps(named)}")
    finally:
        cudnn.deterministic, cudnn.benchmark = prev_cudnn
    moved = max(float((one[n] - start[n]).abs().max()) for n in one)
    print(f"[train] two steps (lr {STEP_LR}) of the float32 student on logical meshes of the "
          f"card against one device, deterministic cuDNN: {json.dumps(shard_apart)}; the "
          f"unsharded step moved the parameters by up to {moved:.3e} (bounds: one device "
          f"against itself bit-equal; mean distance 1% of the mean move, the largest a quarter "
          f"of the summed learning rate, {0.25 * 2 * STEP_LR:.0e}; losses 1e-5 relative)")
    check(repeats, f"the unsharded float32 step differs from itself: {again_apart}")
    check(all(v["mean_over_move"] <= 0.01 and v["max_param_apart"] <= 0.25 * 2 * STEP_LR
              and v.get("loss_rel_apart", 0.0) <= 1e-5 for v in shard_apart.values()),
          f"sharded steps differ: {shard_apart}")

    # a step on the card against the same step on the CPU: the bf16 student,
    # from the shipped weights (the same start in every run), on a 4 x 32 x
    # 32 crop of the batches
    shipped = load_srnet(weights_path("srnet_student"), device="cpu").state_dict()
    crop = [tuple(x[:4, : x.shape[1] // 2, : x.shape[2] // 2] for x in b) for b in batches]
    card, card_losses = sr_steps(make_mesh(devices=[0], device_type="cuda"), torch.bfloat16,
                                 crop, dev, shipped)
    cpu, cpu_losses = sr_steps(make_mesh(devices=[0], device_type="cpu"), torch.bfloat16,
                               [tuple(x.cpu() for x in b) for b in crop], torch.device("cpu"),
                               shipped)
    card_cpu = apart(card, cpu, shipped)
    limit = 0.25 * 2 * STEP_LR
    beyond, failing = tensors_moved_apart(card, cpu, limit)
    # the negative control: the card's up.bias put back where it started
    control = dict(card, **{"up.bias": shipped["up.bias"]})
    control_beyond, control_failing = tensors_moved_apart(control, cpu, limit)
    loss_apart = max(abs(a - b) / b for a, b in zip(card_losses, cpu_losses))
    print(f"[train] two bf16 steps on a crop from the shipped srnet_student, card against CPU: "
          f"{json.dumps(card_cpu)}; elements beyond a quarter of the summed learning rate, of "
          f"the tensor's: {json.dumps({n: [c, cpu[n].numel()] for n, c in beyond.items()})}, "
          f"tensors failing {failing}; losses {loss_apart:.2e} relative apart (bounds: mean "
          f"distance 15% of the mean move, per tensor at most the larger of {BF16_LEAST} "
          f"elements and {BF16_SHARE:.0%} of them beyond, losses 1e-2: the bf16 trunks round "
          f"differently); negative control (the card's up.bias at its start): "
          f"{control_beyond['up.bias']} of {cpu['up.bias'].numel()} beyond, tensors failing "
          f"{control_failing}")
    check("up.bias" in control_failing,
          f"the statistic passes the card's step with up.bias unmoved: {control_beyond}")
    check(card_cpu["mean_over_move"] <= 0.15 and not failing and loss_apart <= 1e-2,
          "the card's step differs from the CPU's")

    # deblur at its defaults, and the 4K finisher
    with tempfile.TemporaryDirectory() as ckpt:
        extra = {}
        for name, call in (("deblur", lambda: train_deblur(TRAIN_EXTRA_STEPS, ckpt, device=dev,
                                                             log_every=100)),
                           ("srnet_4k", lambda: train_srnet_4k(TRAIN_EXTRA_STEPS, ckpt,
                                                                 photo_fraction=0.0,
                                                                 device=dev, log_every=100))):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            t = call()
            torch.cuda.synchronize()
            extra[name] = {"step_ms": [round(x, 2) for x in t.step_ms],
                           "losses": [round(x, 6) for x in t.losses],
                           "peak_bytes": torch.cuda.max_memory_allocated() - held,
                           "transform_launches": LAUNCHES.get("block_transform", 0)}
            check(all(math.isfinite(x) for x in t.losses), f"{name}: a non-finite loss")
            check(extra[name]["transform_launches"] == TRAIN_EXTRA_STEPS,
                  f"{name}: one transform launch per step: {extra[name]}")
        deblur = load_deblur(f"{ckpt}/deblur.npz", device=dev)
        check(deblur.max_strength == 10.0, "the deblur checkpoint's max_strength")
    print(f"[train] deblur (batch 8, patch 64) and srnet_4k (64 x 5 over the frozen "
          f"srnet_compact), {TRAIN_EXTRA_STEPS} steps each, {smi_line}: " + json.dumps(extra))
    return launches


REST_RD_QPS = (26, 38, 51)  # phase 13's rd_sweep: 8 frames of 1080p at three QPs
REST_SEARCH_WH = (640, 360)  # phase 13's two searches: the default config at 360p
REST_TRAIN_STEPS = 5  # phase 13's four trainers at their defaults
REST_TOL = {"bitrate_rel": 0.01, "psnr_mean": 0.1, "ssim_mean": 2e-3, "lpips_mean": 1e-3}


def _part(label, fn, smi_line, parts):
    """Run one part of phase 13: wall (host clock, synchronised), peak
    max_memory_allocated above what was held, transform launches; returns
    ``fn``'s result."""
    from elvis_tpu_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = LAUNCHES.get("block_transform", 0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts[label] = {"ms": round(1e3 * (time.perf_counter() - t0), 2),
                    "peak_bytes": torch.cuda.max_memory_allocated() - held,
                    "transform_launches": LAUNCHES.get("block_transform", 0) - before}
    print(f"[rest] {label}, {smi_line}: {json.dumps(parts[label])}", flush=True)
    return out


def phase_rest(smi_line):
    """The modules of the last slice at full width: ``rd_sweep`` at 8x1080p,
    the grid and random searches (two default runs at 360p each, held to
    direct ``run_elvis`` runs) and ``cleanup_results``, the diffusion,
    inpaint, saliency and perceptual trainers at their defaults (their
    checkpoints through their loaders), the held-out evaluators with the
    shipped nets, and the graft entry points on logical shards of the card.
    Returns the phase's transform launches."""
    import importlib
    import os
    import tempfile

    from elvis_tpu_torch.graft_entry import dryrun_multichip, entry
    from elvis_tpu_torch.kernels import LAUNCHES
    from elvis_tpu_torch.metrics.perceptual import load_perceptual
    from elvis_tpu_torch.models import DiffusionRestorer
    from elvis_tpu_torch.models.io import (
        load_deblur, load_diffusion, load_inpaint, load_saliency, load_srnet, weights_path)
    from elvis_tpu_torch.models.srnet import srnet_upsample_fn
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.search import cleanup, grid, rd_curve
    from elvis_tpu_torch.train import cli as tcli
    from elvis_tpu_torch.train import evaluate

    rsearch = importlib.import_module("elvis_tpu_torch.search.random_search")
    dev = torch.device("cuda")
    parts = {}
    LAUNCHES.clear()

    # the rate-distortion sweep: one point per QP, more bits more PSNR
    curves = _part("rd_sweep", lambda: rd_curve.rd_sweep(
        f"synthetic://moving?frames={N}", W, H, B, qps=REST_RD_QPS, device=dev), smi_line, parts)
    print("[rest] rd curves: " + json.dumps(
        {k: [{m: round(p[m], 4) for m in ("qp", "kbps", "psnr", "ssim")} for p in v]
         for k, v in curves.items()}))
    for label, pts in curves.items():
        check(sorted(p["qp"] for p in pts) == sorted(REST_RD_QPS), f"{label}: one point a QP")
        by_bits = sorted(pts, key=lambda p: p["kbps"])
        check(all(a["psnr"] < b["psnr"] for a, b in zip(by_bits, by_bits[1:])),
              f"{label}: more bits must give more PSNR: {by_bits}")

    # the grid and random searches over two default runs at 360p, each run
    # held to a direct run_elvis of its overrides; then the pruner
    w, h = REST_SEARCH_WH
    space = {"reference_video": [f"synthetic://moving?frames={N}&fps=30"], "width": [w],
             "height": [h], "shrink_amount": [0.25, 0.5]}
    with tempfile.TemporaryDirectory() as root:
        summaries = {
            "grid_search": _part("grid_search", lambda: grid.grid_search(
                space, os.path.join(root, "grid"), device=dev), smi_line, parts),
            "random_search": _part("random_search", lambda: rsearch.random_search(
                space, runs=2, seed=0, results_dir=os.path.join(root, "random"), device=dev),
                smi_line, parts)}
        direct = {}
        for amount in space["shrink_amount"]:
            exp = os.path.join(root, f"direct{amount}")
            cfg = ElvisConfig(reference_video=space["reference_video"][0], width=w, height=h,
                              shrink_amount=amount, experiment_dir=exp)
            direct[amount] = run_elvis(cfg, device=dev)
        apart = {}
        for name, summary in summaries.items():
            check(len(summary) == 2 and all(r["status"] == "ok" for r in summary),
                  f"{name}: {[(r['slug'], r['status'], r.get('error')) for r in summary]}")
            for r in summary:
                a = _rows_apart(r["metrics"], direct[r["overrides"]["shrink_amount"]])
                apart[f"{name} {r['slug']}"] = a
                check(_rows(r["metrics"]) == _rows(direct[r["overrides"]["shrink_amount"]]),
                      f"{name} {r['slug']}: rows {_rows(r['metrics'])}")
                check(all(a[k] <= v for k, v in REST_TOL.items()),
                      f"{name} {r['slug']} differs from the direct run: {a}")
        kept = {d: cleanup.cleanup_results(os.path.join(root, d)) for d in ("grid", "random")}
        leftover = [f for d in kept for f in _walk(os.path.join(root, d))
                    if not f.endswith((".json", ".png"))]
        figures = os.path.isdir(os.path.join(root, "grid", "figures"))
    print(f"[rest] searches against direct run_elvis (tol {json.dumps(REST_TOL)}): "
          f"{json.dumps(apart)}; cleanup kept {json.dumps(kept)}; figures "
          + ("written" if figures else "skipped: no matplotlib on this machine (best-effort, "
             "as in the JAX package)"))
    check(not leftover, f"cleanup left {leftover[:5]}")

    # the four new trainers at their defaults, procedural data (no PIL here)
    trained = {}
    with tempfile.TemporaryDirectory() as ckpt:
        for name in ("diffusion", "inpaint", "saliency", "perceptual"):
            tr = _part(f"train_{name}", lambda name=name: getattr(tcli, f"train_{name}")(
                REST_TRAIN_STEPS, ckpt, photo_fraction=0.0, device=dev, log_every=100),
                smi_line, parts)
            ms = sorted(tr.step_ms[1:])
            trained[name] = {"step_ms_first": round(tr.step_ms[0], 2),
                             "step_ms_median": round(ms[len(ms) // 2], 2),
                             "losses": [round(x, 6) for x in tr.losses]}
            check(all(math.isfinite(x) for x in tr.losses), f"{name}: a non-finite loss")
            path = os.path.join(ckpt, f"{name}.npz")
            gen = torch.Generator(device=dev).manual_seed(SEED)
            x = torch.rand((8, 64, 64, 3), generator=gen, device=dev) * 255
            with torch.no_grad():
                if name == "diffusion":
                    ref = DiffusionRestorer().to(dev)
                    ref.unet.load_state_dict(tr.params())
                    same = torch.equal(load_diffusion(path, dev).sample(x, steps=2),
                                       ref.sample(x, steps=2))
                elif name == "inpaint":
                    mask = (torch.rand((8, 8, 8), generator=gen, device=dev) < 0.25).to(
                        torch.int8)
                    same = torch.equal(load_inpaint(path, dev)(x, mask, B), tr.model(x, mask, B))
                elif name == "saliency":
                    same = torch.equal(load_saliency(path, dev)(x), tr.model(x))
                else:
                    same = all(torch.equal(a, b) for a, b in zip(load_perceptual(path, dev)(x),
                                                                 tr.model(x)))
            check(same, f"{name}: the checkpoint's forward differs from the trained module's")
    print(f"[rest] trainers ({REST_TRAIN_STEPS} steps each, step ms by CUDA events), "
          f"{smi_line}: {json.dumps(trained)}")
    check(parts["train_diffusion"]["transform_launches"] == REST_TRAIN_STEPS,
          f"the diffusion trainer: one transform launch a step, {parts['train_diffusion']}")

    # the held-out evaluators with the shipped nets at the JAX defaults
    student = srnet_upsample_fn(load_srnet(weights_path("srnet_student"), dev))
    sr = _part("sr_holdout_eval", lambda: evaluate.sr_holdout_eval(student, device=dev),
               smi_line, parts)
    deblur = load_deblur(weights_path("deblur"), dev)
    db = _part("deblur_holdout_eval", lambda: evaluate.deblur_holdout_eval(
        lambda f, lv, b: deblur(f, lv, b), device=dev), smi_line, parts)
    photo = evaluate.photo_image() is not None
    print(f"[rest] sr_holdout_eval (srnet_student, 4 frames of 256 px): {json.dumps(sr)}")
    print(f"[rest] deblur_holdout_eval (deblur net): {json.dumps(db)}")
    print(f"[rest] families that ran: {sorted(sr)} / {sorted(db)}"
          + ("" if photo else "; the photo family dropped out: photo_image found no PIL"))
    check(all(math.isfinite(v) for r in (*sr.values(), *db.values()) for v in r.values()),
          "an evaluator's number is not finite")
    check({"leaves", "legacy"} <= set(db) and {"leaves_codec", "legacy_codec"} <= set(sr),
          "the procedural families must run")

    # the graft entry points: the forward on the card, the dry run on 2
    # logical shards of it
    fn, (params, x) = entry(device=dev)
    y = _part("entry", lambda: fn(params, x), smi_line, parts)
    check(tuple(y.shape) == (2, 256, 256, 3) and bool(torch.isfinite(y).all()), "entry()")
    dry = _part("dryrun_multichip(2)", lambda: dryrun_multichip(2, device=dev), smi_line, parts)
    print(f"[rest] dryrun_multichip(2) on logical shards of cuda:0: {json.dumps(dry)}")
    check(dry["logical"], "the dry run's shards are logical on one card")
    launches = dict(LAUNCHES)
    print(f"[rest] transform launches {json.dumps(launches)}; parts {json.dumps(parts)}")
    return launches


def _walk(root):
    import os

    return [os.path.join(d, f) for d, _, files in os.walk(root) for f in files]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        import elvis_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc}); run from the repo root",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count, smi_line = phase_device()
    if "--codec-only" in sys.argv[1:]:  # while working on the codec: no ``ok`` line
        from elvis_tpu_torch.pipeline import ElvisConfig

        frames = make_clip(torch.device("cuda"))
        phase_codec({"frames": frames, "fg": score(frames, ElvisConfig())[1]},
                    "--profile" in sys.argv[1:])
        return 0
    t_start = time.perf_counter()

    def starting(phase):  # a line as each phase starts: a hang is located
        print(f"[phase] {phase} starting at {time.perf_counter() - t_start:.1f} s", flush=True)

    starting("2 kernels")
    kernel_results, frame_rows = phase_kernels()
    starting("2b conv epilogue")
    epilogue_rows = phase_epilogue()
    starting("3 main path")
    launches_main, main_tensors = phase_main_path()
    starting("4 blur path")
    launches_blur = phase_blur_path(main_tensors)
    profile = "--profile" in sys.argv[1:]
    if profile:
        starting("profile")
        phase_profile(main_tensors)
    starting("5 codec")
    launches_codec = phase_codec(main_tensors, profile)
    starting("6 pipeline")
    launches_pipeline, shrunk_stream, removal, default_run = phase_pipeline(smi_line)
    starting("7 fills")
    phase_fills(smi_line, shrunk_stream, removal)
    starting("8 backends")
    launches_backends = phase_backends(smi_line)
    starting("9 external")
    launches_external = phase_external(smi_line)
    starting("10 presley")
    launches_presley = phase_presley(smi_line)
    starting("11 parallel")
    launches_parallel = phase_parallel(smi_line, shrunk_stream, removal, default_run)
    starting("12 train")
    launches_train = phase_train(smi_line)
    starting("13 rest")
    launches_rest = phase_rest(smi_line)
    starting("kernel table")
    # the transform kernel's headline row is what the paths launch: uint8
    # frames, b=8, the main path's table; the batched kernel's is the block
    # contract at the same table (b=8, L=4, M=259,200, C=3); the epilogue's
    # is the student's trunk conv (256 channels, bias and leaky ReLU)
    all_rows = {"block_transform": frame_rows + kernel_results["block_transform"],
                "block_transform_batched": kernel_results["block_transform_batched"],
                "conv_epilogue": epilogue_rows}
    kernels = []
    for kname, (_, source, replaces) in KERNELS.items():
        rows = all_rows[kname]
        by_path = {"main": launches_main.get(kname, 0), "blur": launches_blur.get(kname, 0),
                   "codec": launches_codec.get(kname, 0),
                   "pipeline": launches_pipeline.get(kname, 0),
                   "backends": launches_backends.get(kname, 0),
                   "external": launches_external.get(kname, 0),
                   "presley": launches_presley.get(kname, 0),
                   "parallel": launches_parallel.get(kname, 0),
                   "train": launches_train.get(kname, 0),
                   "rest": launches_rest.get(kname, 0)}
        uint8_rows = [r for r in rows if r.get("uint8_pixels_differing") is not None]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            # float32 rows: max |kernel - plain| (tol 1e-3); uint8 rows apart, in LSB
            "max_abs_err": max(r["max_abs_err"] for r in rows if r not in uint8_rows),
            "uint8_max_lsb_err": max((r["max_abs_err"] for r in uint8_rows), default=None),
            "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"],
            "bound_by": rows[0]["bound_by"],
            "library_ms": rows[0]["library_ms"],
            "rows": rows,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
