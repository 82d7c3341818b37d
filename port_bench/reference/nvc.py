"""Plain reference decoder of NVC streams (the port's codec format, version
4), written from the format with this file's own code and the frozen range
coder beside it (``rangecoder.cpp``, built with ``g++`` at first use).

It reads the P-only streams the benchmark's configurations make: header;
per plane (Y, then Cb and Cr at half size) the mode, vector and coefficient
sections; no ROI map, no B frames, no second reference. Per frame and
plane, block by block:

- levels (zigzag order in the stream, DC as a delta to the previous block
  in raster order when the section's flag says so) times Qstep
  ``2 ** ((QP - 4) / 6)`` (a float64 table rounded to float32), through the
  orthonormal 8x8 inverse DCT;
- a frame whose modes include 4-6 is a spatial intra frame: block rows in
  order, each block predicted from the two reconstructed rows above it
  (raw 0, DC 4 = mean of the row above, vertical 5, gradient 6 =
  ``clip(t1 + r (t1 - t0))``; 128 above the first row);
- otherwise mode 1 blocks add a half-pel motion-compensated prediction from
  the previous reconstruction (a vector ``m`` moves by ``floor(m / 2)``
  pels, an odd one averages two; rows and columns beyond the frame take
  the same row of the nearest edge block), mode 0 blocks are the residual
  alone; every block is clipped to [0, 255];
- the in-loop deblocking filter on block edges, vertical then horizontal;
- 4:2:0 to RGB (BT.601 full range, chroma repeated 2x2), rounded to uint8.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np
import torch

from port_bench.reference.precision import to_tf32
from port_bench.reference.scoring import dct

B = 8
_SRC = Path(__file__).resolve().parent / "rangecoder.cpp"
_lib = None

DEBLOCK_EDGE, DEBLOCK_FLAT, DEBLOCK_TC = 0.8, 0.4, 0.15
QSTEP = np.exp2((np.arange(52, dtype=np.float64) - 4.0) / 6.0).astype(np.float32)


def _library(build_dir: Path) -> ctypes.CDLL:
    global _lib
    if _lib is None:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        path = build_dir / f"libref_rc_{digest}.so"
        if not path.is_file():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
                            str(_SRC)], check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        u8, i16, i64 = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
                        ctypes.c_longlong)
        lib.nvc_rc_decode.restype = i64
        lib.nvc_rc_decode.argtypes = [u8, i64, i64, ctypes.c_int, i16]
        lib.nvc_rc_decode_bytes.restype = i64
        lib.nvc_rc_decode_bytes.argtypes = [u8, i64, i64, u8]
        _lib = lib
    return _lib


def _section(buf: bytes, off: int):
    backend, n = struct.unpack_from("<BI", buf, off)
    return backend, buf[off + 5:off + 5 + n], off + 5 + n


def _bytes(lib, backend: int, payload: bytes, n: int) -> np.ndarray:
    if backend == 1:
        return np.frombuffer(zlib.decompress(payload), np.uint8)[:n].copy()
    src = np.frombuffer(payload, np.uint8)
    out = np.empty(n, np.uint8)
    got = lib.nvc_rc_decode_bytes(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
                                  n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if got != n:
        raise ValueError(f"byte section: {got} of {n} symbols")
    return out


def _coeffs(lib, backend: int, payload: bytes, n: int) -> np.ndarray:
    if backend == 1:
        return np.frombuffer(zlib.decompress(payload), np.int16)[:n].copy()
    src = np.frombuffer(payload, np.uint8)
    out = np.empty(n, np.int16)
    got = lib.nvc_rc_decode(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size, n,
                            B * B, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if got != n:
        raise ValueError(f"coefficient section: {got} of {n} symbols")
    return out


def zigzag() -> np.ndarray:
    """Raster index of each zigzag position of an 8x8 block (JPEG order)."""
    order = sorted(((u, v) for u in range(B) for v in range(B)),
                   key=lambda p: (p[0] + p[1], p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([u * B + v for u, v in order])


def parse(stream: bytes, build_dir: Path) -> dict:
    """Header fields and per plane (levels (N,By,Bx,64) raster order,
    modes (N,By,Bx), vectors (N,By,Bx,2) half-pel)."""
    if stream[:4] != b"NVC1":
        raise ValueError("not an NVC stream")
    version, flags, w, h, n, fps, qp, gop, bfr = struct.unpack_from("<BBHHHfbHB", stream, 4)
    if version != 4 or bfr or flags & 1:
        raise ValueError(f"unsupported stream: version {version}, b byte {bfr}, flags {flags}")
    lib = _library(build_dir)
    off = 4 + struct.calcsize("<BBHHHfbHB")
    ph, pw = h + (-h) % (2 * B), w + (-w) % (2 * B)
    inv = np.empty(B * B, np.int64)
    inv[zigzag()] = np.arange(B * B)
    planes = []
    for by, bx in ((ph // B, pw // B), (ph // (2 * B), pw // (2 * B)),
                   (ph // (2 * B), pw // (2 * B))):
        m = n * by * bx
        bk, pl, off = _section(stream, off)
        modes = _bytes(lib, bk, pl, m).reshape(n, by, bx).astype(np.int64)
        bk, pl, off = _section(stream, off)
        mvs = (_bytes(lib, bk, pl, 2 * m).astype(np.int64) - 128).reshape(n, by, bx, 2)
        bk, pl, off = _section(stream, off)
        zz = _coeffs(lib, bk & 0x7F, pl, m * B * B).reshape(m, B * B).astype(np.int64)
        if bk & 0x80:  # DC coded as the delta to the previous block, per frame
            zz[:, 0] = np.cumsum(zz[:, 0].reshape(n, by * bx), axis=1).reshape(-1)
        planes.append((zz[:, inv].reshape(n, by, bx, B * B), modes, mvs))
    return {"width": w, "height": h, "frames": n, "fps": fps, "qp": qp, "gop": gop,
            "deblock": bool(flags & 2), "padded": (ph, pw), "planes": planes}


def _to_plane(blocks: torch.Tensor) -> torch.Tensor:
    by, bx = blocks.shape[:2]
    return blocks.permute(0, 2, 1, 3).reshape(by * B, bx * B)


def _intra_spatial(res: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Block rows in order; ``res`` (By,Bx,8,8) residuals -> reconstruction."""
    by, bx = modes.shape
    t0 = torch.full((bx, B), 128.0, device=res.device)
    t1 = t0.clone()
    r = torch.arange(1, B + 1, dtype=torch.float32, device=res.device)[:, None]
    rows = []
    for y in range(by):
        m = modes[y][:, None, None]
        dc = t1.mean(dim=1)[:, None, None].expand(bx, B, B)
        vert = t1[:, None, :].expand(bx, B, B)
        grad = torch.clamp(t1[:, None, :] + r * (t1 - t0)[:, None, :], 0.0, 255.0)
        pred = torch.where(m == 4, dc, torch.where(m == 5, vert,
                                                   torch.where(m == 6, grad, 0.0)))
        rec = torch.clamp(res[y] + pred, 0.0, 255.0)
        t0, t1 = rec[:, -2, :], rec[:, -1, :]
        rows.append(rec)
    return _to_plane(torch.stack(rows))


def _edge_block_index(pos: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel index ``pos`` (may lie outside ``[0, size)``) -> the same row
    of the nearest block inside."""
    blk = torch.clamp(torch.div(pos, B, rounding_mode="floor"), 0, size // B - 1)
    return blk * B + torch.remainder(pos, B)


def _motion(prev: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """Half-pel prediction of every pixel from ``prev`` (H, W) with the
    block vectors ``mv`` (By, Bx, 2) in half pels."""
    h, w = prev.shape
    dev = prev.device
    my = mv[..., 0].repeat_interleave(B, 0).repeat_interleave(B, 1)
    mx = mv[..., 1].repeat_interleave(B, 0).repeat_interleave(B, 1)
    yy = torch.arange(h, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev)[None, :].expand(h, w)
    by_, fy = torch.div(my, 2, rounding_mode="floor"), torch.remainder(my, 2)
    bx_, fx = torch.div(mx, 2, rounding_mode="floor"), torch.remainder(mx, 2)
    r0, r1 = _edge_block_index(yy + by_, h), _edge_block_index(yy + by_ + fy, h)
    c0, c1 = _edge_block_index(xx + bx_, w), _edge_block_index(xx + bx_ + fx, w)

    # the vertical taps first, then the horizontal: the order of the port's
    # products, which a rounding could tell apart
    a0, a1 = prev[r0, c0], prev[r1, c0]
    b0, b1 = prev[r0, c1], prev[r1, c1]
    col0 = torch.where(fy == 1, 0.5 * a0 + 0.5 * a1, a0)
    col1 = torch.where(fy == 1, 0.5 * b0 + 0.5 * b1, b0)
    return torch.where(fx == 1, 0.5 * col0 + 0.5 * col1, col0)


def _deblock_vertical_edges(plane: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """The weak filter across each vertical block edge: p1 p0 | q0 q1."""
    h, w = plane.shape
    out = plane.clone()
    qrow = qs.repeat_interleave(B, 0)[:h]                    # (H, Bx)
    q = 0.5 * (qrow[:, :-1] + qrow[:, 1:])                   # (H, Bx - 1)
    e = torch.arange(B, w, B, device=plane.device)            # first column of q0
    p1, p0, q0, q1 = plane[:, e - 2], plane[:, e - 1], plane[:, e], plane[:, e + 1]
    fit = (((p0 - q0).abs() < DEBLOCK_EDGE * q) & ((p1 - p0).abs() < DEBLOCK_FLAT * q)
           & ((q1 - q0).abs() < DEBLOCK_FLAT * q))
    tc = DEBLOCK_TC * q
    delta = torch.clamp(((q0 - p0) * 4.0 + (p1 - q1)) * 0.125, -tc, tc) * fit
    out[:, e - 1] = p0 + delta
    out[:, e] = q0 - delta
    return out


def _deblock(plane: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    plane = _deblock_vertical_edges(plane, qs)
    return _deblock_vertical_edges(plane.t(), qs.t()).t()


def decode_plane(levels, modes, mvs, qp: int, deblock: bool, device,
                 tf32: bool = False) -> torch.Tensor:
    """One plane of every frame -> float32 ``(N, H, W)``."""
    rnd = to_tf32 if tf32 else (lambda t: t)
    n, by, bx, _ = levels.shape
    d = rnd(dct(device))
    q = float(QSTEP[qp])
    qs = torch.full((by, bx), q, device=device)
    prev = torch.zeros((by * B, bx * B), device=device)
    out = []
    for t in range(n):
        coef = torch.as_tensor(levels[t], device=device).float().reshape(by, bx, B, B) * q
        res = torch.einsum("cl,yxbc->yxbl", d, rnd(torch.einsum("kb,yxkc->yxbc", d, rnd(coef))))
        md = torch.as_tensor(modes[t], device=device)
        if bool((md >= 4).any()):
            rec = _intra_spatial(res, md)
        else:
            inter = (md == 1)[..., None, None]
            pred = _motion(prev, torch.as_tensor(mvs[t], device=device))
            pred_blocks = pred.reshape(by, B, bx, B).permute(0, 2, 1, 3)
            rec = _to_plane(torch.clamp(torch.where(inter, res + pred_blocks, res), 0.0, 255.0))
        if deblock:
            rec = _deblock(rec, qs)
        prev = rec
        out.append(rec)
    return torch.stack(out)


def decode(stream: bytes, device, build_dir: Path, tf32: bool = False) -> torch.Tensor:
    """An NVC stream -> uint8 RGB frames ``(N, H, W, 3)`` on ``device``,
    float32 with TF32 off (``tf32=True``: the control, the inverse DCT's
    inputs rounded to TF32)."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = parse(stream, build_dir)
        qp_c = int(np.clip(np.round(float(s["qp"])), 0, 51))
        y, cb, cr = (decode_plane(lv, md, mv, qp, s["deblock"], device, tf32)
                     for (lv, md, mv), qp in zip(s["planes"], (s["qp"], qp_c, qp_c)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    cb = cb.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    cr = cr.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    rgb = torch.stack([y + 1.403 * cr, y - 0.714 * cr - 0.344 * cb, y + 1.773 * cb], dim=-1)
    rgb = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    return rgb[:, :s["height"], :s["width"]]
