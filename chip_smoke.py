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
     function's memory/compute bound; levels outside the table too;
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

``python3 chip_smoke.py --profile`` adds, before the kernel table, a
``torch.profiler`` breakdown of one steady call of the two neural
restorers (device time by kernel name, device busy share).

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


def block_transform_bound_ms(m, b, c, levels):
    """Least time for T[idx] X T[idx]^T: read blocks, idx and table once,
    write the output once; 4 b^3 FLOPs per block and channel (two b x b
    products) at the FP32 rate."""
    nbytes = 2 * m * b * b * c * 4 + m * 4 + levels * b * b * 4
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


def phase_kernels():
    """Build both kernels; per shape, hold each to the plain version and to
    the other, and time them. Returns ``{kernel name: [result per shape]}``,
    the main path's shape first."""
    from elvis_tpu_torch.kernels import _build
    from elvis_tpu_torch.kernels import block_transform as bt
    from elvis_tpu_torch.restore.unsharp import _unsharp_blur_table

    t0 = time.time()
    times = _build.build_all()
    print(f"[build] {len(times)} source(s) compiled in {time.time() - t0:.1f} s: "
          f"{json.dumps({k: round(v, 1) for k, v in times.items()})}")
    check(set(times) == set(KERNELS), f"built {sorted(times)}, expected {sorted(KERNELS)}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

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
    return results


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
    check(launches.get("block_transform", 0) >= 1,
          f"the main path launched no block_transform kernel: {launches}")
    print(f"[main] kernel launches on the main path: {json.dumps(launches)}")
    print(f"[main] first pass per stage (ms, CUDA events, includes cuDNN warm-up): "
          f"{json.dumps({k: round(v, 3) for k, v in first_ms.items()})}")
    steady = [run_path()[-1] for _ in range(3)]
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
        ev[0].record()
        blurred, rounds = adaptive_blur(frames, scores, B, max_rounds)
        ev[1].record()
        out = {"deblur_net": deblur(blurred, rounds, B)}
        ev[2].record()
        out["unsharp"] = unsharp(blurred, rounds, B)
        ev[3].record()
        out["lanczos"] = restore_downsample_lanczos(degraded, levels, B)
        ev[4].record()
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
    check(launches.get("block_transform", 0) >= 3,
          f"the blur path launched block_transform fewer than 3 times: {launches}")
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
    steady = [run_path()[-1] for _ in range(3)]
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


def phase_profile(main):
    """Device time by kernel of one steady call of each neural restorer."""
    from torch.profiler import ProfilerActivity, profile

    from elvis_tpu_torch.degrade import adaptive_blur
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_deblur_backend, resolve_sr_backend

    cfg = ElvisConfig()
    dev = torch.device("cuda")
    restore, _ = resolve_sr_backend(cfg.sr_backends[0], cfg, device=dev)
    deblur, _ = resolve_deblur_backend(cfg.deblur_backends[0], cfg, device=dev)
    blurred, rounds = adaptive_blur(main["frames"], main["scores"], B, cfg.gaussian_max_rounds)
    calls = {"progressive_restore": lambda: restore(main["degraded"], main["levels"], B),
             "deblur_net": lambda: deblur(blurred, rounds, B)}
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
    kernel_results = phase_kernels()
    launches_main, main_tensors = phase_main_path()
    launches_blur = phase_blur_path(main_tensors)
    if "--profile" in sys.argv[1:]:
        phase_profile(main_tensors)
    kernels = []
    for kname, (_, source, replaces) in KERNELS.items():
        shape = kernel_results[kname][0]  # b=8, L=4, M=259,200, C=3: the main path's
        by_path = {"main": launches_main.get(kname, 0), "blur": launches_blur.get(kname, 0)}
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in kernel_results[kname]),
            "ms": shape["ms"],
            "plain_ms": shape["plain_ms"],
            "bound_ms": shape["bound_ms"],
            "bound_by": shape["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
