#!/usr/bin/env python3
"""The table of the port's hand-written CUDA kernels, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any fault exits non-zero and prints no
``ok`` line):

  1. device: name, count, and ``nvidia-smi``'s name and power limit;
  2. build the native libraries (``kernels/_build.build_all``: one compiler
     per source, started together) and hold each transform kernel against
     the plain PyTorch version and against the other on the card, at the two
     paths' shapes and tables, timed with CUDA events against the
     function's memory/compute bound and beside its library route; levels
     outside the table too. The transform kernel is held in both of its
     layouts: float32 blocks, and frames as they lie in memory (uint8 and
     float32, with and without the unsharp epilogue) against the plain
     composition of split, transform, combine, round and clip;
  2b. the SR nets' conv epilogue kernel (``csrc/conv_epilogue.cu``; no TPU
     kernel) at the nets' trunk conv outputs on 8 x 540 x 960: the
     student's convs (256 channels bf16: bias and leaky ReLU) and its ``up``
     (12: bias alone, the kernel's channel-wrapping form), RRDB's ``fuse``
     (128: bias and two residuals) and its ``up`` (512: bias and leaky
     ReLU); Real-ESRGAN's growth convs (32 at its widest body, 8 x 270 x
     480: bias and leaky ReLU), its last dense block's ``conv5`` there (64:
     bias and two residuals) and its ``conv_hr`` (64 at 8 x 1080 x 1920,
     bias and leaky ReLU); each held bit-equal to the plain version, timed
     beside its byte bound and beside PyTorch's own route (the cuDNN path's
     ``add_`` of the bias over the channels-last NCHW view, then each op
     as its own pass; never called by the port); ptxas registers and spills;
  2c. the SR nets' float32 tail kernel (``csrc/tail_conv.cu``; no TPU
     kernel) at the restore cells' shapes: RRDB's finest stage in phase
     form (8 x 540 x 960 x 2 x 2 x 128), Real-ESRGAN's ``conv_last`` at 2x
     (8 x 1080 x 1920 x 64) and the student's phase tail (Cin 3); each held
     to the plain version, timed beside its bound (bf16 read once, float32
     written once; 54 Cin FLOPs an output pixel at the FP32 rate) and beside
     the nets' own plain route, which the card took before the kernel (a
     float32 copy, then cuDNN's float32 conv over the NCHW view, in the
     phase form with the scattered 4 Cin -> 12 kernel; TF32 off);
  2d. E2FGVI-HQ's modulated deformable conv (``csrc/dcn.cu``, the sampling
     into a bf16 column buffer, then one cuBLAS GEMM; no TPU kernel) at the
     e2fgvi_hq cell's propagation step (1 x 270 x 486 x 256, 16 groups, to
     128) and over 8 such frames: the columns bit-equal to the plain
     version's, the conv timed whole and its sampling alone beside the
     conv's bound (its GEMM's FLOPs at the bf16 rate, or its least bytes:
     bf16 features in, float32 offsets and mask in, bf16 output out) and
     beside the plain version on the card; no library route exists
     (PyTorch has no deformable conv, ``torchvision`` is not installed);
  2e. E2FGVI-HQ's feed-forward fold (``csrc/ffn_fold.cu``: fold, its
     normalisation, unfold, GELU and the bf16 cast in one pass; no TPU
     kernel) at the e2fgvi_hq cell's two forwards (8 and 6 frames of 90 x
     162 tokens of 1960, a 270 x 486 map): bit-equal to the plain version,
     two calls bit-equal, timed beside its byte bound (fc1's bf16 output read
     once, fc2's input written once) and the plain version (PyTorch's
     float32 fold, division, unfold and GELU, which the card ran before);
     and the span from fc1's output to fc2's both ways: the plain version
     then fc2 over its transposed view, against the kernel then fc2 over its
     contiguous output. No library route exists.

The port's paths are gated on the card by the ``-m gpu`` tests
(``python -m pytest tests/test_torch_gpu.py tests/test_torch_conv_epilogue.py
tests/test_torch_tail_conv.py tests/test_torch_ffn_fold.py -m gpu --noconftest
-q``) and timed by the benchmark (``port_bench/run.py``).

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
BF16_FLOP_PER_S = 989e12
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
    print(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    return name, count


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
    "tail_conv": ("tail_conv.tail_conv_cuda",
                  "elvis_tpu_torch/kernels/csrc/tail_conv.cu",
                  "none: XLA runs the flax model's float32 tail conv"),
    "dcn": ("dcn.deform_columns_cuda",
            "elvis_tpu_torch/kernels/csrc/dcn.cu",
            "none: the JAX package has no deformable conv"),
    "ffn_fold": ("ffn_fold.ffn_fold_gelu_cuda",
                 "elvis_tpu_torch/kernels/csrc/ffn_fold.cu",
                 "none: XLA fuses the JAX model's fold and unfold"),
}
BLOCK_KERNELS = ("block_transform", "block_transform_batched")  # phase 2's pair
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
    cuda = sorted(n for n, (src, _) in _build.SOURCES.items() if src.suffix == ".cu")
    check(cuda == sorted(KERNELS), f"CUDA sources {cuda}, expected {sorted(KERNELS)}")
    found = [n for n in _build.SOURCES if n not in times]  # built by an earlier run
    if found:
        print(f"[build] already built from these sources: {found}")
    check(all(_build._lib_path(n).is_file() for n in _build.SOURCES), "a library is missing")
    for name in KERNELS:
        if name in _build.BUILD_LOGS:
            print(f"[ptxas] {name}: {ptxas_summary(_build.BUILD_LOGS[name])}")

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
    ("realesrgan_growth_bias_slope", (N, H // 4, W // 4, 32), 0.2, None, None),
    ("realesrgan_conv5_bias_two_residuals", (N, H // 4, W // 4, 64), None, 0.2, 0.2),
    ("realesrgan_hr_bias_slope", (N, H, W, 64), 0.2, None, None),
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


TAIL_ROWS = [  # (label, input shape): the restore cells' tails
    ("rrdb_phase_finest", (N, H // 2, W // 2, 2, 2, 128)),
    ("realesrgan_conv_last", (N, H, W, 64)),
    ("student_phase_finest", (N, H // 2, W // 2, 2, 2, 3)),
]


def phase_tail():
    """The tail kernel at the cells' shapes: held to the plain version (tol
    1e-3), timed with CUDA events beside its bound, the plain version and
    the nets' own plain route (phase 2 built it). Returns the rows."""
    from elvis_tpu_torch.device import full_fp32
    from elvis_tpu_torch.kernels import tail_conv as tc
    from elvis_tpu_torch.models.srnet import _nhwc_conv, _TailConv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for label, shape in TAIL_ROWS:
        cin = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 2).to(torch.bfloat16)
        tail = _TailConv(cin).to(dev)
        with torch.no_grad():
            tail.weight.copy_(torch.randn(tail.weight.shape, generator=gen, device=dev)
                              / (9 * cin) ** 0.5)
            tail.bias.copy_(torch.randn(3, generator=gen, device=dev))
        w, b = tail.weight.detach(), tail.bias.detach()
        if x.dim() == 6:  # the nets' plain routes
            def before():
                return tail._phase_plain(x.float())
        else:
            def before():
                with full_fp32():
                    return _nhwc_conv(x.float(), w, b)
        got = tc.tail_conv_cuda(x, w, b)
        want = tc.tail_conv(x, w, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= KERNEL_TOL, f"tail_conv {label}: kernel and plain version differ by {err}")
        err_before = (before() - want).abs().max().item()
        del got, want
        calls = {"kernel": lambda: tc.tail_conv_cuda(x, w, b), "library": before}
        runs = {k: [] for k in calls}
        for key in list(calls) + list(reversed(calls)):
            runs[key].append(cuda_ms(calls[key], iters=20 if key == "kernel" else 5))
        plain_ms = cuda_ms(lambda: tc.tail_conv(x, w, b), iters=5)
        pixels = x.numel() // cin  # full-resolution output pixels
        nbytes = 2 * x.numel() + 4 * 3 * pixels + 4 * w.numel()
        flops = 2 * 27 * cin * pixels
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        bound, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        ms, lib_ms = (sum(runs[k]) / len(runs[k]) for k in ("kernel", "library"))
        print(f"[tail] {label} {shape}: max |kernel - plain| {err:.3g} (the nets' route "
              f"{err_before:.3g}); kernel {ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['kernel'])}), the nets' route "
              f"{lib_ms:.4f} ms ({', '.join(f'{r:.4f}' for r in runs['library'])}), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: {nbytes:,} B, "
              f"{flops:,} FLOP), {bound / ms:.1%} of bound")
        rows.append({"label": label, "shape": list(shape), "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": lib_ms})
        del x, tail, w, b
        torch.cuda.empty_cache()
    print(json.dumps({"tail": rows}))
    return rows


DCN_ROWS = [  # (label, frames): the e2fgvi_hq cell's propagation step, and 8 of them
    ("e2fgvi_step", 1),
    ("e2fgvi_8_frames", 8),
]


def phase_dcn():
    """The deformable conv at the cell's shapes: the columns held bit-equal
    to the plain version, the conv within the GEMM's bf16 rounding of it,
    timed with CUDA events beside its bound and the plain version (phase 2
    built it). Returns the rows."""
    from elvis_tpu_torch.kernels import dcn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h, w, c, groups, co = H // 4, (W + 24) // 4, 256, 16, 128  # 1080x1944 padded, at 1/4
    rows = []
    for label, n in DCN_ROWS:
        x = torch.randn((n, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
        flow = torch.randn((n, 1, 1, 2), generator=gen, device=dev) * 3
        offset = (10 * torch.tanh(0.3 * torch.randn((n, h, w, 18 * groups), generator=gen,
                                                     device=dev))
                  + flow.repeat(1, h, w, 9 * groups)).contiguous()
        mask = torch.sigmoid(torch.randn((n, h, w, 9 * groups), generator=gen, device=dev))
        weight = (torch.randn((co, c, 3, 3), generator=gen, device=dev)
                  / (9 * c) ** 0.5).to(torch.bfloat16)
        bias = torch.randn((co,), generator=gen, device=dev).to(torch.bfloat16)
        for i in range(n):
            got = dcn.deform_columns_cuda(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups)
            want = dcn.deform_columns(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups)
            check(torch.equal(got, want), f"dcn {label}: columns differ from the plain version")
            del got, want
        out = dcn.modulated_deform_conv(x, offset, mask, weight, bias, groups)
        plain = torch.cat([torch.addmm(bias, dcn.deform_columns(
            x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups).reshape(-1, 9 * c),
            dcn.pack_weight(weight, groups)).reshape(1, h, w, co) for i in range(n)])
        err = (out.float() - plain.float()).abs().max().item()
        check(err <= KERNEL_TOL, f"dcn {label}: kernel and plain version differ by {err}")
        del out, plain

        def kernel():
            return dcn.modulated_deform_conv(x, offset, mask, weight, bias, groups)

        def sampling():
            for i in range(n):
                dcn.deform_columns_cuda(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups)

        def plain_route():
            for i in range(n):
                cols = dcn.deform_columns(x[i:i + 1], offset[i:i + 1], mask[i:i + 1], groups)
                torch.addmm(bias, cols.reshape(-1, 9 * c), dcn.pack_weight(weight, groups))

        runs = {"kernel": [], "sampling": []}
        for key in ("kernel", "sampling", "sampling", "kernel"):
            runs[key].append(cuda_ms(kernel if key == "kernel" else sampling, iters=10))
        plain_ms = cuda_ms(plain_route, iters=2, warmup=1)
        pixels = n * h * w
        nbytes = pixels * (2 * c + 4 * 27 * groups + 2 * co) + 2 * 9 * c * co * n
        flops = 2 * 9 * c * co * pixels
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
        bound, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        ms, sample_ms = (sum(runs[k]) / len(runs[k]) for k in ("kernel", "sampling"))
        print(f"[dcn] {label} ({n}, {h}, {w}, {c}) -> {co}, {groups} groups: columns bit-equal, "
              f"max |conv - plain| {err:.3g}; conv {ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['kernel'])}), sampling alone "
              f"{sample_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
              f"{nbytes:,} B, {flops:,} FLOP), {bound / ms:.1%} of bound")
        rows.append({"label": label, "shape": [n, h, w, c, groups, co], "max_abs_err": err,
                     "ms": ms, "sampling_ms": sample_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": bound_by, "library_ms": None})
        del x, offset, mask
        torch.cuda.empty_cache()
    print(json.dumps({"dcn": rows}))
    return rows


FFN_ROWS = [  # (label, frames): the e2fgvi_hq cell's forwards over frames 0-7 and 0-5
    ("e2fgvi_8_frames", 8),
    ("e2fgvi_6_frames", 6),
]


def phase_ffn():
    """The feed-forward fold at the cell's shapes: bit-equal to the plain
    version, two calls bit-equal, timed with CUDA events beside its byte
    bound and the plain version, and with fc2 after each (phase 2 built
    it). Returns the rows."""
    import torch.nn.functional as F

    from elvis_tpu_torch.kernels import ffn_fold as ff

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    size = (H // 4, (W + 24) // 4)  # 1080x1944 padded, at 1/4
    th, tw = ff.token_grid(size)
    hidden, dim = 1960, 512
    w2 = (torch.randn((dim, hidden), generator=gen, device=dev) / hidden ** 0.5).to(torch.bfloat16)
    b2 = (torch.randn((dim,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    rows = []
    for label, n in FFN_ROWS:
        h = (torch.randn((n, th * tw, hidden), generator=gen, device=dev) * 0.7).to(torch.bfloat16)
        got = ff.ffn_fold_gelu_cuda(h, th, tw, size)
        again = ff.ffn_fold_gelu_cuda(h, th, tw, size)
        want = ff.ffn_fold_gelu(h, th, tw, size)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"ffn_fold {label}: {int((got != want).sum())} values "
                                      f"differ from the plain version")
        check(torch.equal(got, again), f"ffn_fold {label}: two calls differ")
        del got, again, want

        def kernel():
            return ff.ffn_fold_gelu_cuda(h, th, tw, size)

        def plain():
            return ff.ffn_fold_gelu(h, th, tw, size)

        def fc2_before():
            return F.linear(ff.ffn_fold_gelu(h, th, tw, size), w2, b2)

        def fc2_after():
            return F.linear(ff.ffn_fold_gelu_cuda(h, th, tw, size), w2, b2)

        runs = {"kernel": [], "plain": []}
        for key in ("kernel", "plain", "plain", "kernel"):
            runs[key].append(cuda_ms(kernel if key == "kernel" else plain,
                                     iters=20 if key == "kernel" else 3))
        before_ms = cuda_ms(fc2_before, iters=3)
        after_ms = cuda_ms(fc2_after, iters=10)
        nbytes = 2 * 2 * h.numel()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms, plain_ms = (sum(runs[k]) / len(runs[k]) for k in ("kernel", "plain"))
        print(f"[ffn_fold] {label} ({n}, {th * tw}, {hidden}): bit-equal to the plain version, "
              f"two calls bit-equal; kernel {ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['kernel'])}), plain {plain_ms:.4f} ms "
              f"({', '.join(f'{r:.4f}' for r in runs['plain'])}), bound {bound:.4f} ms (bytes: "
              f"{nbytes:,} B), {bound / ms:.1%} of bound; with fc2: the plain version then fc2 "
              f"over its view {before_ms:.4f} ms, the kernel then fc2 {after_ms:.4f} ms")
        rows.append({"label": label, "shape": [n, th * tw, hidden], "max_abs_err": 0.0,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": None, "with_fc2_before_ms": before_ms,
                     "with_fc2_ms": after_ms})
        del h
        torch.cuda.empty_cache()
    print(json.dumps({"ffn_fold": rows}))
    return rows


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
    name, count = phase_device()
    kernel_results, frame_rows = phase_kernels()
    epilogue_rows = phase_epilogue()
    tail_rows = phase_tail()
    dcn_rows = phase_dcn()
    ffn_rows = phase_ffn()
    # the transform kernel's headline row is what the paths launch: uint8
    # frames, b=8, the main path's table; the batched kernel's is the block
    # contract at the same table (b=8, L=4, M=259,200, C=3); the epilogue's
    # is the student's trunk conv (256 channels, bias and leaky ReLU); the
    # tail's is RRDB's finest stage; the deformable conv's one propagation step;
    # the feed-forward fold's the cell's 8-frame forward
    all_rows = {"block_transform": frame_rows + kernel_results["block_transform"],
                "block_transform_batched": kernel_results["block_transform_batched"],
                "conv_epilogue": epilogue_rows,
                "tail_conv": tail_rows,
                "dcn": dcn_rows,
                "ffn_fold": ffn_rows}
    kernels = []
    for kname, (_, source, replaces) in KERNELS.items():
        rows = all_rows[kname]
        uint8_rows = [r for r in rows if r.get("uint8_pixels_differing") is not None]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
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
