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


KERNELS = {  # name -> (wrapper in kernels.block_transform, source, TPU kernel replaced)
    "block_transform": ("apply_block_matrix_cuda",
                        "elvis_tpu_torch/kernels/csrc/block_transform.cu",
                        "elvis_tpu/kernels/block_transform.py:241"),
    "block_transform_batched": ("apply_block_matrix_batched_cuda",
                                "elvis_tpu_torch/kernels/csrc/block_transform_batched.cu",
                                "elvis_tpu/kernels/block_transform.py:119"),
}
KERNEL_TOL = 1e-3
U8_SHARE_TOL = 1e-3  # share of uint8 pixels that may differ (by 1 LSB) from the plain version


def ptxas_summary(log):
    """Kernels, registers and spills of one nvcc run's ptxas report."""
    regs = [int(w.split()[0]) for w in log.split("Used")[1:]]
    spills = [line.strip() for line in log.splitlines()
              if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    return (f"{len(regs)} kernel(s), registers {min(regs)}-{max(regs)}, "
            f"{len(spills)} with spills" + (f": {spills[:3]}" if spills else ""))


def plain_frames(bt, frames, t, levels, b, amount=None):
    """The plain composition the frame layout replaces: cast, split into
    blocks, transform (einsums), the unsharp combine, put together, round
    and clip, cast back. ``t`` and ``amount`` are device tensors."""
    from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks

    x = split_into_blocks(frames, b).float()
    out = bt.apply_block_matrix(x, t, levels)
    if amount is not None:
        a = amount[levels.long()][..., None, None, None]
        out = torch.where(a > 0, torch.clamp((1.0 + a) * x - a * out, 0, 255), x)
    out = combine_blocks(out)
    if frames.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)


def phase_frame_layout(bt, gen):
    """The transform kernel on frames: each row held to the plain
    composition and timed against the bound of the function in these
    types. Returns the rows, the main path's (uint8, b=8, resample) first."""
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

        got = kernel()
        torch.cuda.synchronize()
        want = plain_frames(bt, frames, t, levels, b, amount)
        check(got.dtype == dtype and got.shape == frames.shape, f"{label}: output type or shape")
        if dtype == u8:
            diff = (got.int() - want.int()).abs()
            err, differing = float(diff.max().item()), int((diff > 0).sum().item())
            share = differing / diff.numel()
            check(err <= 1 and share <= U8_SHARE_TOL,
                  f"{label}: {err} LSB on {differing} pixels ({share:.2e}) vs the plain version")
            held = f"max {err:.0f} LSB on {differing} of {diff.numel()} pixels (tol 1 LSB)"
            del diff
        else:
            err, differing = (got - want).abs().max().item(), None
            check(math.isfinite(err) and err <= KERNEL_TOL,
                  f"{label}: max |kernel - plain| = {err} > {KERNEL_TOL}")
            held = f"max_abs_err {err:.3g} (tol {KERNEL_TOL})"
        if epilogue:  # blocks with amount 0 come back bit-exact
            keep = (levels == 0).repeat_interleave(b, -1).repeat_interleave(b, -2)[..., None]
            check(torch.equal(torch.where(keep, got, 0), torch.where(keep, frames, 0)),
                  f"{label}: a level-0 block changed under the unsharp epilogue")
        del got, want
        runs = [cuda_ms(kernel, iters=50) for _ in range(2)]
        plain_ms = cuda_ms(lambda: plain_frames(bt, frames, t, levels, b, amount), iters=3,
                           warmup=1)
        size = frames.element_size()
        m = levels.numel()
        bound, by = block_transform_bound_ms(m, b, 3, ell, size, size)
        ms = sum(runs) / len(runs)
        print(f"[kernel] block_transform {label} {N}x{hh}x{W}x3: {held}, kernel {ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs)}), plain composition {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
        results.append({"label": label, "max_abs_err": err, "uint8_pixels_differing": differing,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
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
    fns = {name: getattr(bt, KERNELS[name][0]) for name in KERNELS}
    m8, m16 = N * (H // 8) * (W // 8), N * (H // 16) * (W // 16)
    both = tuple(KERNELS)
    shapes = [  # (label, b, table, M, C, kernels): the main path's table first
        ("b8_L4_resample_linear", 8, bt.resample_matrix_table(8, "linear"), m8, 3, both),
        ("b8_L11_blur", 8, bt.blur_matrix_table(8, 10), m8, 3, both),
        ("b8_L11_unsharp", 8, _unsharp_blur_table(8, 10), m8, 3, both),
        ("b8_L4_lanczos4", 8, bt.resample_matrix_table(8, "lanczos4"), m8, 3, both),
        ("b16_L5_resample_linear", 16, bt.resample_matrix_table(16, "linear"), m16, 3, both),
        ("b16_L5_resample_linear_C1", 16, bt.resample_matrix_table(16, "linear"), m16, 1,
         ("block_transform_batched",)),
    ]
    results = {name: [] for name in KERNELS}
    for label, b, table, m, c, names in shapes:
        ell = table.shape[0]
        x = torch.rand((m, b, b, c), generator=gen, device=dev) * 255
        idx = torch.randint(0, ell, (m,), generator=gen, device=dev, dtype=torch.int32)
        t = torch.as_tensor(table, dtype=torch.float32, device=dev)
        want = bt.apply_block_matrix(x, t, idx)
        got, errs = {}, {}
        for name in names:
            got[name] = fns[name](x, t, idx)
            torch.cuda.synchronize()
            errs[name] = (got[name] - want).abs().max().item()
            check(math.isfinite(errs[name]) and errs[name] <= KERNEL_TOL,
                  f"{name} {label}: max |kernel - plain| = {errs[name]} > {KERNEL_TOL}")
        if len(names) == 2:
            cross = (got[names[0]] - got[names[1]]).abs().max().item()
            check(cross <= KERNEL_TOL, f"{label}: the two kernels differ by {cross}")
            print(f"[kernel] {label}: max |block_transform - block_transform_batched| = "
                  f"{cross:.3g} (tol {KERNEL_TOL})")
        del got, want
        # the kernels in turns (a, b, b, a), 50 launches each time
        order = list(names) + list(reversed(names))
        runs = {name: [] for name in names}
        for name in order:
            runs[name].append(cuda_ms(lambda: fns[name](x, t, idx), iters=50))
        plain_ms = cuda_ms(lambda: bt.apply_block_matrix(x, t, idx), iters=10)
        bound, by = block_transform_bound_ms(m, b, c, ell)
        for name in names:
            ms = sum(runs[name]) / len(runs[name])
            print(f"[kernel] {name} {label} M={m} C={c}: max_abs_err {errs[name]:.3g} "
                  f"(tol {KERNEL_TOL}), kernel {ms:.4f} ms "
                  f"({', '.join(f'{r:.4f}' for r in runs[name])}), plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
            results[name].append({"label": label, "max_abs_err": errs[name], "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
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
    degraded, levels, restored, metrics, first_ms = run_path()
    launches = dict(LAUNCHES)
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
    name, count, _ = phase_device()
    if "--codec-only" in sys.argv[1:]:  # while working on the codec: no ``ok`` line
        from elvis_tpu_torch.pipeline import ElvisConfig

        frames = make_clip(torch.device("cuda"))
        phase_codec({"frames": frames, "fg": score(frames, ElvisConfig())[1]},
                    "--profile" in sys.argv[1:])
        return 0
    kernel_results, frame_rows = phase_kernels()
    launches_main, main_tensors = phase_main_path()
    launches_blur = phase_blur_path(main_tensors)
    profile = "--profile" in sys.argv[1:]
    if profile:
        phase_profile(main_tensors)
    launches_codec = phase_codec(main_tensors, profile)
    # the transform kernel's headline row is what the paths launch: uint8
    # frames, b=8, the main path's table; the batched kernel's is the block
    # contract at the same table (b=8, L=4, M=259,200, C=3)
    all_rows = {"block_transform": frame_rows + kernel_results["block_transform"],
                "block_transform_batched": kernel_results["block_transform_batched"]}
    kernels = []
    for kname, (_, source, replaces) in KERNELS.items():
        rows = all_rows[kname]
        by_path = {"main": launches_main.get(kname, 0), "blur": launches_blur.get(kname, 0),
                   "codec": launches_codec.get(kname, 0)}
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
            "library_ms": None,
            "rows": rows,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
