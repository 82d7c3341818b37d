#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any fault exits non-zero and prints no
``ok`` line):

  1. device: name, count, and ``nvidia-smi``'s name and power limit;
  2. build the hand-written CUDA kernels from ``elvis_tpu_torch/kernels/csrc``
     (one ``nvcc`` per source, started together) and hold each against its
     plain PyTorch version on the card, at the main path's shapes, timed
     with CUDA events against its memory/compute bound;
  3. the main path at full width: bench.py's 8-frame 1080p moving-gradient
     clip (plus seeded noise) -> complexity + motion-contrast saliency ->
     removability scores -> ``adaptive_downsample`` (through the kernel) ->
     ``resolve_sr_backend("realesrgan")`` (the committed ``srnet_student``,
     256 ch x 6 convs) -> ``progressive_restore`` -> masked PSNR / SSIM;
     then the same slice on a small crop on the card and on the CPU, held
     to each other.

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


def phase_kernels():
    from elvis_tpu_torch.kernels import _build
    from elvis_tpu_torch.kernels import block_transform as bt

    t0 = time.time()
    times = _build.build_all()
    print(f"[build] {len(times)} source(s) compiled in {time.time() - t0:.1f} s: "
          f"{json.dumps({k: round(v, 1) for k, v in times.items()})}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m_main = N * (H // B) * (W // B)
    shapes = [  # (label, b, table, M): the main path's table first
        ("b8_L4_resample_linear", 8, bt.resample_matrix_table(8, "linear"), m_main),
        ("b8_L11_blur", 8, bt.blur_matrix_table(8, 10), m_main),
        ("b16_L5_resample_linear", 16, bt.resample_matrix_table(16, "linear"),
         N * (H // 16) * (W // 16)),
    ]
    results = []
    for label, b, table, m in shapes:
        ell = table.shape[0]
        x = torch.rand((m, b, b, 3), generator=gen, device=dev) * 255
        idx = torch.randint(0, ell, (m,), generator=gen, device=dev, dtype=torch.int32)
        t = torch.as_tensor(table, dtype=torch.float32, device=dev)
        got = bt.apply_block_matrix_cuda(x, t, idx)
        torch.cuda.synchronize()
        want = bt.apply_block_matrix(x, t, idx)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(math.isfinite(err) and err <= 1e-3,
              f"block_transform {label}: max |kernel - plain| = {err} > 1e-3")
        ms = cuda_ms(lambda: bt.apply_block_matrix_cuda(x, t, idx), iters=50)
        plain_ms = cuda_ms(lambda: bt.apply_block_matrix(x, t, idx), iters=10)
        bound, by = block_transform_bound_ms(m, b, 3, ell)
        print(f"[kernel] block_transform {label} M={m} C=3: max_abs_err {err:.3g} "
              f"(tol 1e-3), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
        results.append({"label": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by})
        del x, idx, got, want

    # the backward (same transform with T^T) goes through the kernel too
    x = (torch.rand((2, 6, 5, 8, 8, 3), generator=gen, device=dev) * 255).requires_grad_(True)
    idx = torch.randint(0, 11, (2, 6, 5), generator=gen, device=dev, dtype=torch.int32)
    table = bt.blur_matrix_table(8, 10)
    (bt.apply_block_matrix_fast(x, table, idx) ** 2).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    tt = torch.as_tensor(table, dtype=torch.float32, device=dev)
    (bt.apply_block_matrix(xr, tt, idx) ** 2).sum().backward()
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
    return launches, summary


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
    launches, _ = phase_main_path()
    main_shape = kernel_results[0]
    table = {"kernels": [{
        "name": "block_transform",
        "route": "cuda",
        "source": "elvis_tpu_torch/kernels/csrc/block_transform.cu",
        "replaces": "elvis_tpu/kernels/block_transform.py:241",
        "launches": launches.get("block_transform", 0),
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
