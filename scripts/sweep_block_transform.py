#!/usr/bin/env python3
"""Sweep the transform kernel's tile size and grid on one NVIDIA GPU.

    python3 scripts/sweep_block_transform.py [--iters 50]

For the shapes of an 8-frame 1080p clip (uint8 frames at b=8 and b=16,
float32 frames, float32 blocks) it times ``csrc/block_transform.cu`` with
the tile size the wrapper picks and with other groups (blocks per tile)
and caps on the grid (CTAs per SM), CUDA events, 50 launches a reading. It
prints one line per setting and the card's name and power limit; it changes
nothing. The PyTorch/CUDA port only; needs the card.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N, H, W, C = 8, 1080, 1920, 3


def cuda_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_block_transform: no CUDA device", file=sys.stderr)
        return 2
    from elvis_tpu_torch.kernels import block_transform as bt

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # (label, b, dtype, layout, groups)
        ("frames_u8_b8", 8, torch.uint8, "frames", (None, 16, 32, 40, 48, 60, 64, 80, 96, 120)),
        ("frames_u8_b16", 16, torch.uint8, "frames", (None, 8, 16, 24, 30, 40, 60)),
        ("frames_f32_b8", 8, torch.float32, "frames", (None, 16, 20, 24, 30, 32, 40, 48)),
        ("blocks_f32_b8", 8, torch.float32, "blocks", (None, 16, 24, 32, 48)),
        ("blocks_f32_b16", 16, torch.float32, "blocks", (None, 2, 4, 8, 12, 16)),
    ]
    for label, b, dtype, layout, groups in cases:
        table = bt.resample_matrix_table(b, "linear")
        t = bt.device_table(table, dev)
        h = H - H % b
        frames = torch.randint(0, 256, (N, h, W, C), generator=gen, device=dev, dtype=torch.uint8)
        levels = torch.randint(0, table.shape[0], (N, h // b, W // b), generator=gen, device=dev,
                               dtype=torch.int32)
        if layout == "frames":
            x, idx, frame = frames.to(dtype), levels, True
        else:
            from elvis_tpu_torch.core.blocks import split_into_blocks

            x = split_into_blocks(frames, b).float().reshape(-1, b, b, C).contiguous()
            idx, frame = levels.reshape(-1), False
        picked = bt._group_size(b, C, table.shape[0], frame=frame, in_size=x.element_size(),
                                out_size=x.element_size(), bx=W // b if frame else None)
        for group in groups:
            for per_sm in (0, 1, 2, 3, 4):
                g = picked if group is None else group

                def fn():
                    return bt._launch_transform(x, t, idx, None, dtype, frame=frame, b=b,
                                                group=g, max_ctas=per_sm * sms)

                try:
                    ms = cuda_ms(fn, args.iters)
                except (RuntimeError, ValueError) as exc:
                    print(f"{label} group {g} ctas/SM {per_sm}: {exc}")
                    break
                smem = bt._transform_smem_bytes(b, C, table.shape[0], g, frame=frame,
                                                in_size=x.element_size(),
                                                out_size=x.element_size())
                print(f"{label} group {g}{' (picked)' if group is None else ''} "
                      f"ctas/SM {per_sm or 'auto'} smem {smem}: {ms:.4f} ms")
        del x, frames, levels
    return 0


if __name__ == "__main__":
    sys.exit(main())
