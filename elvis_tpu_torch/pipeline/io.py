"""Clip I/O (port of ``elvis_tpu.pipeline.io``): many sources -> one
``(N, H, W, 3)`` uint8 array.

Sources: procedural synthetic clips (``synthetic://<kind>?frames=N``), PNG
directories, ``.npy`` / ``.npz`` arrays, Y4M files and NVC bitstreams. Any
other file (an mp4) goes through ffmpeg (``codec.external``), and raises
``FileNotFoundError`` where there is none.

PNG is read and written with ``zlib`` and ``struct`` from the standard
library: 8-bit grey, grey+alpha, RGB and RGBA, non-interlaced; the writer
uses filter 0 on every row, the reader undoes all five filters and also
reads 8-bit palette images (DAVIS-style mask annotations) as RGB.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "load_clip",
    "load_masks",
    "save_frames_png",
    "load_frames_png",
    "synthetic_clip",
    "write_png",
    "read_png",
]


def synthetic_clip(
    kind: str = "moving", frames: int = 24, height: int = 360, width: int = 640,
    seed: int = 0,
) -> np.ndarray:
    """Procedural clips with a moving foreground object over textured
    background -- enough structure for saliency/ROI to be meaningful."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    tex = 24 * np.sin(2 * np.pi * xx / 37) * np.cos(2 * np.pi * yy / 29)
    out = np.empty((frames, height, width, 3), dtype=np.uint8)
    for t in range(frames):
        base = 110 + tex + 18 * np.sin(2 * np.pi * (xx + 3 * t) / 160)
        frame = np.stack([base, base * 0.95, base * 1.05], axis=-1)
        if kind in ("moving", "object"):
            cy = height // 2 + int(0.18 * height * np.sin(2 * np.pi * t / frames))
            cx = int(width * (0.25 + 0.5 * t / max(frames - 1, 1)))
            r = min(height, width) // 6
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            obj = np.stack([
                205 + 28 * np.sin(2 * np.pi * (xx + yy) / 23),
                90 + 20 * np.cos(2 * np.pi * xx / 17),
                70 + 15 * np.sin(2 * np.pi * yy / 19),
            ], axis=-1)
            frame = np.where(mask[..., None], obj, frame)
        frame += rng.normal(0, 2.0, frame.shape)
        out[t] = np.clip(frame, 0, 255).astype(np.uint8)
    return out


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS_OF = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples a pixel
_TYPE_OF = {v: k for k, v in _CHANNELS_OF.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """``(H, W)`` or ``(H, W, C)`` uint8 (C in 1..4) -> an 8-bit PNG, every
    row with filter 0."""
    img = np.asarray(image, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum of each byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0, dtype=np.uint64) % 256).astype(np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left result
            x, up = line.tolist(), prev.tolist()
            r = [0] * stride
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                if kind == 3:
                    r[i] = (x[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    r[i] = (x[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.asarray(r, np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0..4")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced grey / grey+alpha / RGB / RGBA PNG ->
    ``(H, W, C)`` uint8 with C = 1, 2, 3 or 4; a palette PNG -> its RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = header
    indexed = ctype == 3 and palette is not None
    if depth != 8 or not (ctype in _CHANNELS_OF or indexed) or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A)/palette PNGs are "
                         f"read (depth {depth}, colour type {ctype}, interlace {interlace})")
    c = 1 if indexed else _CHANNELS_OF[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)
    return palette[rows[..., 0]] if indexed else rows


def _to_rgb(img: np.ndarray) -> np.ndarray:
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _to_gray(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")``: ITU-R 601-2 luma in 16-bit fixed point,
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    c = img.shape[-1]
    if c in (1, 2):
        return img[..., 0]
    rgb = img[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def save_frames_png(frames, out_dir: str, start_number: int = 1) -> None:
    """%05d.png naming like the reference. ``frames``: ``(N, H, W[, C])``
    uint8, a numpy array or a tensor."""
    if hasattr(frames, "detach"):
        frames = frames.detach().cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(np.asarray(frames)):
        write_png(os.path.join(out_dir, f"{i + start_number:05d}.png"), frame)


def _png_files(src_dir: str):
    return sorted(f for f in os.listdir(src_dir) if f.lower().endswith(".png"))


def load_frames_png(src_dir: str) -> np.ndarray:
    frames = [_to_rgb(read_png(os.path.join(src_dir, f))) for f in _png_files(src_dir)]
    return np.stack(frames, axis=0)


def load_masks(
    masks_dir: str, width: int, height: int, expected_frames: int,
    device: "str | object" = "cuda",
) -> np.ndarray:
    """Foreground masks (DAVIS-style grayscale PNGs) as ``(N, H, W)`` bool
    host array, nearest-resized on ``device``, ``> 128`` threshold,
    last-mask carry-forward for missing frames."""
    import torch

    from elvis_tpu_torch.device import resolve_device
    from elvis_tpu_torch.ops.resize import resize

    dev = resolve_device(device)
    files = _png_files(masks_dir) if os.path.isdir(masks_dir) else []
    masks = []
    last = np.zeros((height, width), dtype=bool)
    for i in range(expected_frames):
        if i < len(files):
            img = _to_gray(read_png(os.path.join(masks_dir, files[i])))
            if img.shape != (height, width):
                img = resize(torch.as_tensor(img.astype(np.float32)[None], device=dev),
                             (height, width), method="nearest").cpu().numpy()[0]
            last = img > 128
        masks.append(last)
    return np.stack(masks, axis=0)


def load_clip(
    source: str,
    width: Optional[int] = None,
    height: Optional[int] = None,
    max_frames: Optional[int] = None,
    device: "str | object" = "cuda",
) -> Tuple[np.ndarray, float]:
    """-> ((N,H,W,3) uint8 RGB host array, framerate). Decodes an NVC
    stream and resizes to width x height when given (area to shrink,
    lanczos to grow) on ``device``."""
    from elvis_tpu_torch.device import resolve_device

    device = resolve_device(device)
    fps = 30.0
    if source.startswith("synthetic://"):
        m = re.match(r"synthetic://(\w+)\??(.*)", source)
        kind = m.group(1)
        params = dict(p.split("=") for p in m.group(2).split("&") if "=" in p)
        frames = synthetic_clip(
            kind,
            frames=int(params.get("frames", 24)),
            height=int(params.get("height", height or 360)),
            width=int(params.get("width", width or 640)),
            seed=int(params.get("seed", 0)),
        )
        fps = float(params.get("fps", 30.0))
    elif source.endswith(".y4m"):
        from elvis_tpu_torch.codec.y4m import read_y4m

        frames, fps = read_y4m(source)
    elif source.endswith((".npy", ".npz")):
        data = np.load(source)
        if isinstance(data, np.lib.npyio.NpzFile):
            frames = data["frames"]
            fps = float(data["framerate"]) if "framerate" in data else 30.0
        else:
            frames = data
    elif source.endswith(".nvc"):
        from elvis_tpu_torch.codec import nvc_decode

        with open(source, "rb") as f:
            decoded, fps = nvc_decode(f.read(), device=device)
        frames = decoded.cpu().numpy()
    elif os.path.isdir(source):
        frames = load_frames_png(source)
    else:
        from elvis_tpu_torch.codec.external import decode_video_ffmpeg, is_available

        if not is_available("ffmpeg"):
            raise FileNotFoundError(
                f"cannot read {source!r}: no ffmpeg in this environment; use "
                "y4m/npz/png-dir/nvc or synthetic:// sources"
            )
        assert width and height, "mp4 decode needs explicit width/height"
        frames = decode_video_ffmpeg(source, width, height)

    if max_frames is not None:
        frames = frames[:max_frames]
    if width and height and (frames.shape[1] != height or frames.shape[2] != width):
        import torch

        from elvis_tpu_torch.ops.resize import resize

        method = "area" if frames.shape[1] > height else "lanczos4"
        frames = resize(torch.as_tensor(np.ascontiguousarray(frames), device=device),
                        (height, width), method=method).cpu().numpy()
    return np.ascontiguousarray(frames), fps
