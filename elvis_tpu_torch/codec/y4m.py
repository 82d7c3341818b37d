"""Y4M (YUV4MPEG2) reader/writer (port of ``elvis_tpu.codec.y4m``): the
uncompressed interchange format.

Header ``YUV4MPEG2 W{w} H{h} F{fps*1000}:1000 Ip A1:1 C420``, I420 planar
payload; RGB <-> I420 through the port's own ``ops.color``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from elvis_tpu_torch.ops.color import rgb_to_yuv420, yuv420_to_rgb

__all__ = ["write_y4m", "read_y4m"]


def write_y4m(frames: Sequence[np.ndarray], path: str, framerate: float) -> None:
    """frames: sequence/array of (H, W, 3) uint8 RGB."""
    arr = np.asarray(frames)
    n, h, w = arr.shape[0], arr.shape[1], arr.shape[2]
    y, cb, cr = (p.numpy() for p in rgb_to_yuv420(torch.from_numpy(np.ascontiguousarray(arr))))
    fps_num = int(round(framerate * 1000))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps_num}:1000 Ip A1:1 C420\n".encode())
        for i in range(n):
            f.write(b"FRAME\n")
            f.write(y[i].astype(np.uint8).tobytes())
            f.write(cb[i].astype(np.uint8).tobytes())
            f.write(cr[i].astype(np.uint8).tobytes())


def read_y4m(path: str) -> Tuple[np.ndarray, float]:
    """-> ((N, H, W, 3) uint8 RGB, framerate)."""
    with open(path, "rb") as f:
        header = f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"not a Y4M file: {path}")
        w = h = 0
        fps = 30.0
        for tok in header.strip().split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                fps = float(num) / float(den)
            elif tok[0] == "C" and tok[1:] not in ("420", "420jpeg", "420mpeg2"):
                raise ValueError(f"unsupported Y4M chroma {tok}")
        ys, cbs, crs = [], [], []
        y_size, c_size = w * h, (w // 2) * (h // 2)
        while True:
            marker = f.readline()
            if not marker:
                break
            if not marker.startswith(b"FRAME"):
                raise ValueError("corrupt Y4M frame marker")
            buf = f.read(y_size + 2 * c_size)
            if len(buf) < y_size + 2 * c_size:
                break
            ys.append(np.frombuffer(buf, np.uint8, y_size).reshape(h, w))
            cbs.append(np.frombuffer(buf, np.uint8, c_size, y_size).reshape(h // 2, w // 2))
            crs.append(np.frombuffer(buf, np.uint8, c_size, y_size + c_size).reshape(h // 2, w // 2))
    rgb = yuv420_to_rgb(*(torch.from_numpy(np.stack(p)) for p in (ys, cbs, crs)))
    return rgb.numpy(), fps
