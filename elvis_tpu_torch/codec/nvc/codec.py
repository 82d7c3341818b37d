"""NVC codec: container, rate control, ROI (port of
``elvis_tpu.codec.nvc.codec``).

Layout: 4:2:0 YCbCr; 8x8 luma blocks, 8x8 chroma blocks at half resolution
(frame dims padded to multiples of 16, original size kept in the header).
Transform, quantization and reconstruction run on the device
(``elvis_tpu_torch.codec.nvc.transform``); zigzag, DC prediction and entropy
coding run on the host (``elvis_tpu_torch.codec.nvc.entropy``, the native
range coder). The stream format is the JAX package's: either package decodes
the other's streams.

Levels cross the host link as int16, once per plane and segment; modes and
vectors as int8.

Two-pass bitrate targeting: pass 1 probes bits(QP), pass 2 encodes at QP
shifted by the ~6 QP per bits-doubling law, with one refinement probe when
the miss exceeds 15%. Clips of 48 frames and more fit the rate model on
frame prefixes and pay one full encode.

Under ``torch.profiler`` each ``encode`` records the spans ``nvc.encode``
and, inside it, ``nvc.encode.planes`` (colour conversion and the plane
encodes), ``nvc.encode.download`` and ``nvc.encode.pack`` (``write_stream``);
each ``decode`` records ``nvc.decode`` with ``nvc.decode.unpack``
(``read_stream``), ``nvc.decode.planes`` (uploads and plane decodes) and
``nvc.decode.rgb``. The ``nvc`` counters ``encode.frames`` and
``encode.bytes`` add up every finished encode
(``elvis_tpu_torch.utils.trace``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple, Union

import numpy as np
import torch

from elvis_tpu_torch.codec.nvc import entropy
from elvis_tpu_torch.codec.nvc.transform import (
    BLOCK,
    decode_plane,
    decode_plane_b,
    encode_plane,
    encode_plane_b,
    zigzag_order,
)
from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.ops.color import rgb_to_yuv420, yuv420_to_rgb
from elvis_tpu_torch.ops.resize import resize
from elvis_tpu_torch.utils.trace import counter, span

__all__ = ["NvcCodec", "NvcStream", "encode", "decode", "luma_modes", "section_backends",
           "write_stream", "read_stream"]

_MAGIC = b"NVC1"
_PAD = 2 * BLOCK  # luma pad so chroma planes are whole-block too

# clips at least this long rate-target via prefix probes (one full encode)
# instead of 2-3 full two-pass encodes; see NvcCodec._encode_targeted_prefix
_PREFIX_PROBE_MIN_FRAMES = 48

Frames = Union[np.ndarray, torch.Tensor]
Device = Union[str, torch.device, None]


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Edge-replicate ``(N, H, W, C)`` frames up to multiples of ``mult``."""
    n, h, w, c = x.shape
    ph = (-h) % mult
    pw = (-w) % mult
    if ph:
        x = x.index_select(1, torch.clamp(torch.arange(h + ph, device=x.device), max=h - 1))
    if pw:
        x = x.index_select(2, torch.clamp(torch.arange(w + pw, device=x.device), max=w - 1))
    return x


@dataclasses.dataclass
class NvcStream:
    """Decoded header info (for tooling/tests)."""

    width: int
    height: int
    num_frames: int
    framerate: float
    base_qp: int
    has_roi: bool
    size_bytes: int


def _qp_maps(
    n: int, by: int, bx: int, base_qp: int, roi_delta_qp: Optional[np.ndarray]
) -> np.ndarray:
    qp = np.full((n, by, bx), base_qp, dtype=np.int32)
    if roi_delta_qp is not None:
        d = np.asarray(roi_delta_qp)
        if d.shape[1:] != (by, bx):
            d = resize(torch.from_numpy(d.astype(np.float32)), (by, bx), method="area",
                       channels=False).numpy()
        qp = qp + np.clip(np.round(d), -14, 14).astype(np.int32)  # kvazaar-style clamp
    return np.clip(qp, 0, 51)


def _chroma_qp(luma_qp: np.ndarray) -> np.ndarray:
    """Chroma grid is half the luma grid: area-reduce the QP map."""
    n, by, bx = luma_qp.shape
    q = luma_qp.reshape(n, by // 2, 2, bx // 2, 2).mean(axis=(2, 4))
    return np.clip(np.round(q), 0, 51).astype(np.int32)


def _reach_of(mvs: np.ndarray) -> int:
    """Prediction-neighbourhood radius (in blocks) covering a stream's
    stored half-pel vectors: ceil(max|mv2| / (2*BLOCK))."""
    m = int(np.abs(mvs.astype(np.int16)).max()) if mvs.size else 0
    return max(1, -(-m // (2 * BLOCK)))


# ---- bounded-memory chunked encode/decode -------------------------------
# A clip's float planes, levels and reconstructions all live on the device
# while it is encoded, so long clips are encoded in SEGMENTS: each one is
# converted, encoded and downloaded on its own, carrying the (prev, prev2)
# reference reconstructions across the boundary on the device, with
# per-segment force-intra flags preserving the gop phase. Chunked output
# equals the single-loop path byte for byte. ``b_frames`` streams stay
# single-loop: a segment-final B frame's backward reference lives in the
# next segment.
_CHUNK_PIXEL_BUDGET = 1 << 25  # ~32M luma pixels/segment (16 frames @1080p)


def _chunk_frames_for(n: int, h: int, w: int, chunk_frames: Optional[int]) -> int:
    if chunk_frames is not None and int(chunk_frames) > 0:
        return max(2, int(chunk_frames))
    return max(2, _CHUNK_PIXEL_BUDGET // (h * w))


def _carry(recon: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prev, prev2) for the next segment (on a 1-frame tail segment
    prev2 := prev; the carry is unused after the last one)."""
    return recon[-1], recon[max(recon.shape[0] - 2, 0)]


def _to_host(planes):
    """Device planes ``[(levels, modes, mvs)] * 3`` -> numpy, one download
    per array."""
    with span("nvc.encode.download"):
        return [tuple(a.cpu().numpy() for a in plane) for plane in planes]


def _encode_planes(rgb, qp_y, qp_c, gop, me_radius, me_step, me_halfpel,
                   b_frames=False, b_qp_offset=2, multi_ref=False, deblock=False,
                   intra_pred=True, frame_offset=0, init=None):
    """Colour conversion and the three plane encodes of one clip or segment
    on ``rgb``'s device. ``rgb`` uint8 ``(N,H,W,3)``, ``qp_y``/``qp_c`` int
    tensors. Returns ``[(levels, modes, mvs)] * 3`` and the three
    reconstructions (Y, Cb, Cr). ``frame_offset`` (the segment's first
    frame) and ``init`` (per-plane reference carries) are the chunked
    path's; not with ``b_frames``."""
    with span("nvc.encode.planes"):
        y, cb, cr = rgb_to_yuv420(rgb.float())
        kw = dict(me_radius=me_radius, me_step=me_step, me_halfpel=me_halfpel,
                  multi_ref=multi_ref, deblock=deblock, intra_pred=intra_pred)
        if b_frames:
            enc = encode_plane_b
            kw.update(gop=gop, b_qp_offset=b_qp_offset)
        else:
            enc = encode_plane
            kw.update(gop=gop, frame_offset=frame_offset)
        # chroma at half resolution: half the search radius
        ckw = dict(kw, me_radius=max(me_radius // 2, 0))
        init = init or (None, None, None)
        planes, recons = [], []
        for plane, qp, k, carry in ((y, qp_y, kw, init[0]), (cb, qp_c, ckw, init[1]),
                                    (cr, qp_c, ckw, init[2])):
            if carry is not None:
                k = dict(k, init_recon=carry)
            lv, md, mv, rec = enc(plane, qp, **k)
            planes.append((lv, md, mv))
            recons.append(rec)
        return planes, recons


def _encode_planes_chunked(padded, qp_y, qp_c, gop, me_radius, me_step, me_halfpel,
                           multi_ref, chunk, deblock=False, intra_pred=True, device=None):
    """``padded``: uint8 ``(N,H,W,3)`` tensor on any device; each segment
    is moved to ``device``, converted and encoded on its own. Returns host
    arrays ``[(levels, modes, mvs)] * 3``."""
    n = padded.shape[0]
    init = None
    acc = [[[], [], []] for _ in range(3)]
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        planes, recons = _encode_planes(
            padded[s:e].to(device),
            torch.as_tensor(qp_y[s:e], device=device),
            torch.as_tensor(qp_c[s:e], device=device),
            gop, me_radius, me_step, me_halfpel, multi_ref=multi_ref, deblock=deblock,
            intra_pred=intra_pred, frame_offset=s, init=init,
        )
        init = tuple(_carry(r) for r in recons)
        for p, plane in enumerate(_to_host(planes)):
            for i, a in enumerate(plane):
                acc[p][i].append(a)
    return [tuple(np.concatenate(parts, axis=0) for parts in plane) for plane in acc]


def _pack_section(backend: int, payload: bytes) -> bytes:
    return struct.pack("<BI", backend, len(payload)) + payload


# OR'ed into a coeff section's backend byte. The high bit is RESERVED for
# this flag so entropy backend ids (entropy.BACKEND_*) can grow to 0x7F
# without colliding; write_stream asserts the invariant.
_DC_DPCM_FLAG = 0x80


def _dc_dpcm(coeff_zz: np.ndarray, blocks_per_frame: int) -> Optional[np.ndarray]:
    """JPEG-style DC prediction: replace each block's DC level with the
    delta to the previous block's (raster order, per frame). Lossless
    integer transform on the LEVELS, so reconstruction is untouched. Returns
    None when a delta would overflow int16 (the section is then stored
    plain)."""
    dc = coeff_zz[:, 0].astype(np.int32).reshape(-1, blocks_per_frame)
    dcd = np.diff(dc, axis=1, prepend=0)
    if np.abs(dcd).max(initial=0) > 32767:
        return None
    out = coeff_zz.copy()
    out[:, 0] = dcd.reshape(-1).astype(np.int16)
    return out


def _dc_dpcm_inverse(coeff_zz: np.ndarray, blocks_per_frame: int) -> np.ndarray:
    dcd = coeff_zz[:, 0].astype(np.int32).reshape(-1, blocks_per_frame)
    coeff_zz[:, 0] = np.cumsum(dcd, axis=1).reshape(-1).astype(np.int16)
    return coeff_zz


def _unpack_section(buf: memoryview, off: int) -> Tuple[int, bytes, int]:
    backend, ln = struct.unpack_from("<BI", buf, off)
    off += 5
    return backend, bytes(buf[off: off + ln]), off + ln


def write_stream(
    planes,
    *,
    width: int,
    height: int,
    qp: int,
    framerate: float = 30.0,
    gop: int = 0,
    qp_y: Optional[np.ndarray] = None,
    deblock: bool = True,
    b_frames: bool = False,
    b_qp_offset: int = 2,
) -> bytes:
    """The host half of ``encode``: header, then per plane the mode, vector
    and coefficient sections.

    ``planes``: ``[(levels, modes, mvs)] * 3`` (Y, Cb, Cr) as host arrays:
    levels ``(N,By,Bx,64)`` int16 in raster coefficient order, modes
    ``(N,By,Bx)`` int8, mvs ``(N,By,Bx,2)`` int8 half-pel (``(N,By,Bx,2,2)``
    [fwd, bwd] with ``b_frames``). ``qp_y``: the final luma QP map
    ``(N,By,Bx)`` when the stream carries an ROI section, else None."""
    n = planes[0][0].shape[0]
    zz = zigzag_order(BLOCK)
    header = _MAGIC + struct.pack(
        "<BBHHHfbHB",
        # version 4 = spatial intra prediction may appear (mode bytes 4-6);
        # layout identical to v3 (3 = b_frames byte present)
        4,
        # flags byte: bit 0 = per-block ROI QP map section present,
        # bit 1 = in-loop deblocking (decoder must filter identically)
        (1 if qp_y is not None else 0) | (2 if deblock else 0),
        width,
        height,
        n,
        float(framerate),
        int(qp),
        int(gop),
        # 0 = P-only; k>0 = B frames with b_qp_offset = k-1
        (1 + int(b_qp_offset)) if b_frames else 0,
    )
    parts = [header]
    if qp_y is not None:
        # the final luma QP map (already clamped) as uint8
        parts.append(_pack_section(*entropy.encode_bytes(qp_y.astype(np.uint8))))
    for levels, modes, mvs in planes:
        parts.append(_pack_section(*entropy.encode_bytes(modes.astype(np.uint8))))
        if b_frames:
            # Backward vectors exist only on odd (B) frames: the even
            # frames' all-zero bwd slots are not stored.
            mvs = np.concatenate(
                [mvs[:, :, :, 0, :].reshape(-1), mvs[1::2, :, :, 1, :].reshape(-1)]
            )
        parts.append(_pack_section(*entropy.encode_bytes(
            (mvs.astype(np.int16).reshape(-1) + 128).astype(np.uint8))))
        coeff_zz = levels.reshape(-1, BLOCK * BLOCK)[:, zz]
        dpcm = _dc_dpcm(coeff_zz, levels.shape[1] * levels.shape[2])
        bk_c, pl_c = entropy.encode_coeffs(coeff_zz if dpcm is None else dpcm, BLOCK * BLOCK)
        assert bk_c < _DC_DPCM_FLAG, "entropy backend id collides with DPCM flag"
        parts.append(_pack_section(bk_c | (0 if dpcm is None else _DC_DPCM_FLAG), pl_c))
    return b"".join(parts)


def _encode_device(frames: Frames, device: Device) -> torch.device:
    """The device an encode runs on: ``device`` when given, else the
    tensor's own, else (a numpy array) ``"cuda"``. Raises without a card
    unless the CPU was asked for."""
    if device is None:
        device = frames.device if isinstance(frames, torch.Tensor) else "cuda"
    return resolve_device(device)


def encode(
    frames: Frames,
    *,
    qp: int = 32,
    framerate: float = 30.0,
    roi_delta_qp: Optional[np.ndarray] = None,
    gop: int = 0,
    me_radius: int = 4,
    me_step: int = 1,
    me_halfpel: bool = True,
    b_frames: bool = False,
    b_qp_offset: int = 2,
    multi_ref: bool = False,
    chunk_frames: Optional[int] = None,
    deblock: bool = True,
    intra_pred: bool = True,
    device: Device = None,
) -> bytes:
    """frames ``(N, H, W, 3)`` uint8 RGB, a numpy array or a tensor -> NVC
    bitstream bytes.

    ``device``: where the transform stage runs; default the tensor's own
    device, ``"cuda"`` for a numpy array (raises without a card).

    ``deblock``: in-loop deblocking of every reference reconstruction
    (transform.deblock_plane); header flag bit 0x02 so the decoder filters
    identically.

    ``intra_pred``: spatial intra prediction (DC/vertical/gradient from the
    reconstructed rows above, RD-selected per block) on full-intra frames.
    Mode values 4-6 mark predicted blocks; decoders dispatch on them per
    frame. Version byte 4 announces the capability (header layout is
    identical to v3).

    ``chunk_frames``: frames per bounded-memory encode segment (None = by
    pixel budget, 16 frames at 1080p). Chunked streams equal single-loop
    ones byte for byte. ``b_frames`` clips always encode in one loop.

    ``multi_ref``: two-reference P prediction (per-block selection between
    the previous and two-back reconstructions, mode MODE_INTER_REF2). The
    decoder engages the two-ref path iff mode 2 appears on P frames, so no
    header change.

    Memory: motion search materializes per-block ``(By, Bx, W, W)``
    prediction neighbourhoods with ``W = (2*reach+1)*8``, ~(2*reach+1)^2
    float32 copies of the frame; at 1080p keep ``me_radius <= ~24``.
    """
    if b_frames and not (0 <= int(b_qp_offset) <= 254):
        # the header stores (1 + b_qp_offset) in one byte; -1 would encode
        # as 0 = "P-only" and mis-parse the mv sections
        raise ValueError(f"b_qp_offset must be in [0, 254], got {b_qp_offset}")
    with span("nvc.encode"):
        dev = _encode_device(frames, device)
        n, orig_h, orig_w, _ = frames.shape
        h, w = orig_h + (-orig_h) % _PAD, orig_w + (-orig_w) % _PAD
        by, bx = h // BLOCK, w // BLOCK
        qp_y = _qp_maps(n, by, bx, qp, roi_delta_qp)
        qp_c = _chroma_qp(qp_y)

        chunk = _chunk_frames_for(n, h, w, chunk_frames)
        padded = _pad_to(torch.as_tensor(frames), _PAD)  # where the frames lie
        if not b_frames and n > chunk:
            planes = _encode_planes_chunked(
                padded, qp_y, qp_c, int(gop), me_radius, me_step, me_halfpel, bool(multi_ref),
                chunk, bool(deblock), bool(intra_pred), device=dev,
            )
        else:
            planes, _ = _encode_planes(
                padded.to(dev),
                torch.as_tensor(qp_y, device=dev), torch.as_tensor(qp_c, device=dev),
                int(gop), me_radius, me_step, me_halfpel, bool(b_frames), int(b_qp_offset),
                bool(multi_ref), bool(deblock), bool(intra_pred),
            )
            planes = _to_host(planes)
        with span("nvc.encode.pack"):
            stream = write_stream(
                planes, width=orig_w, height=orig_h, qp=qp, framerate=framerate, gop=gop,
                qp_y=qp_y if roi_delta_qp is not None else None, deblock=deblock,
                b_frames=b_frames, b_qp_offset=b_qp_offset,
            )
    counts = counter("nvc")
    counts["encode.frames"] += n
    counts["encode.bytes"] += len(stream)
    return stream


def _read_header(stream: bytes):
    """Parse a v2, v3 or v4 header -> (version, has_roi, w, h, n, fps, qp,
    gop, b_byte, deblock, payload_offset). ``b_byte``: 0 = P-only, k>0 = B
    frames with b_qp_offset = k-1. ``has_roi``/``deblock`` are bits 0/1 of
    the flags byte."""
    assert stream[:4] == _MAGIC, "not an NVC stream"
    if stream[4] >= 3:
        fmt = "<BBHHHfbHB"
        version, flags, w, h, n, fps, qp, gop, bfr = struct.unpack_from(fmt, stream, 4)
    else:
        fmt = "<BBHHHfbH"
        version, flags, w, h, n, fps, qp, gop = struct.unpack_from(fmt, stream, 4)
        bfr = 0
    return (version, flags & 1, w, h, n, fps, qp, gop, int(bfr),
            bool(flags & 2), 4 + struct.calcsize(fmt))


def read_stream(stream: bytes):
    """The host half of ``decode``: parse and entropy-decode a stream ->
    (header tuple of ``_read_header``, luma QP map ``(N,By,Bx)`` int32,
    ``[(levels int16 (N,By,Bx,64) raster order, modes int8, mvs int8)] * 3``)."""
    header = _read_header(stream)
    (_, has_roi, orig_w, orig_h, n, _, base_qp, _, bfr, _, off) = header
    buf = memoryview(stream)
    h = orig_h + ((-orig_h) % _PAD)
    w = orig_w + ((-orig_w) % _PAD)
    by, bx = h // BLOCK, w // BLOCK
    cby, cbx = by // 2, bx // 2

    if has_roi:
        bk, pl, off = _unpack_section(buf, off)
        qp_y = entropy.decode_bytes(bk, pl, n * by * bx).reshape(n, by, bx).astype(np.int32)
    else:
        qp_y = np.full((n, by, bx), base_qp, dtype=np.int32)

    zz = zigzag_order(BLOCK)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(zz.size)

    nb = n // 2
    planes = []
    for by_, bx_ in ((by, bx), (cby, cbx), (cby, cbx)):
        bk_m, pl_m, off = _unpack_section(buf, off)
        modes = entropy.decode_bytes(bk_m, pl_m, n * by_ * bx_).reshape(n, by_, bx_)
        bk_v, pl_v, off = _unpack_section(buf, off)
        n_mv = n * by_ * bx_ * 2 + (nb * by_ * bx_ * 2 if bfr else 0)
        flat_mv = (
            entropy.decode_bytes(bk_v, pl_v, n_mv).astype(np.int16) - 128
        ).astype(np.int8)
        if bfr:
            fwd = flat_mv[: n * by_ * bx_ * 2].reshape(n, by_, bx_, 2)
            bwd_odd = flat_mv[n * by_ * bx_ * 2:].reshape(nb, by_, bx_, 2)
            mvs = np.zeros((n, by_, bx_, 2, 2), np.int8)
            mvs[:, :, :, 0, :] = fwd
            mvs[1::2, :, :, 1, :] = bwd_odd
        else:
            mvs = flat_mv.reshape(n, by_, bx_, 2)
        bk_c, pl_c, off = _unpack_section(buf, off)
        flat = entropy.decode_coeffs(
            bk_c & ~_DC_DPCM_FLAG, pl_c, n * by_ * bx_ * BLOCK * BLOCK, BLOCK * BLOCK
        ).reshape(-1, BLOCK * BLOCK)
        if bk_c & _DC_DPCM_FLAG:
            flat = _dc_dpcm_inverse(flat, by_ * bx_)
        levels = flat[:, inv].reshape(n, by_, bx_, BLOCK * BLOCK)
        planes.append((levels, modes.astype(np.int8), mvs))
    return header, qp_y, planes


def _decode_planes(planes, qps, sizes, dev, *, bfr, deblock, init=None):
    """Upload and decode the three planes of a clip or segment; returns the
    reconstructions (Y, Cb, Cr) float32 on ``dev``. The per-frame and
    per-plane switches (reach, two references, spatial intra frames) are
    read from the host arrays before the upload."""
    with span("nvc.decode.planes"):
        recons = []
        for p, ((levels, modes, mvs), qp, (h, w)) in enumerate(zip(planes, qps, sizes)):
            # mode 2 on the P chain => the stream used multi-reference P (on B
            # streams odd-frame mode 2 is the backward reference, so only even
            # frames are inspected)
            p_modes = modes[::2] if bfr else modes
            kw = dict(reach=_reach_of(mvs), multi_ref=bool((p_modes == 2).any()),
                      deblock=deblock,
                      spatial=(modes.reshape(modes.shape[0], -1) >= 4).any(axis=1).tolist())
            args = [torch.as_tensor(a, device=dev) for a in (levels, modes, mvs, qp)]
            if bfr:
                recons.append(decode_plane_b(*args, h, w, b_qp_offset=bfr - 1, **kw))
            else:
                recons.append(decode_plane(*args, h, w,
                                           init_recon=None if init is None else init[p], **kw))
        return recons


def decode(stream: bytes, device: Device = "cuda") -> Tuple[torch.Tensor, float]:
    """NVC bitstream -> (frames ``(N,H,W,3)`` uint8 RGB on ``device``,
    framerate)."""
    with span("nvc.decode"):
        dev = resolve_device(device)
        with span("nvc.decode.unpack"):
            header, qp_y, planes = read_stream(stream)
        (_, _, orig_w, orig_h, n, fps, _, _, bfr, deblock, _) = header
        h = orig_h + ((-orig_h) % _PAD)
        w = orig_w + ((-orig_w) % _PAD)
        qp_c = _chroma_qp(qp_y)
        qps = (qp_y, qp_c, qp_c)
        sizes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))

        def to_rgb(recons):
            with span("nvc.decode.rgb"):
                rgb = torch.clamp(torch.round(yuv420_to_rgb(*recons)), 0, 255).to(torch.uint8)
                return rgb[:, :orig_h, :orig_w]

        chunk = _chunk_frames_for(n, h, w, None)
        if bfr or n <= chunk:
            return to_rgb(_decode_planes(planes, qps, sizes, dev, bfr=bfr,
                                         deblock=deblock)).contiguous(), float(fps)
        # bounded-memory decode: one loop per segment, reference carry across
        # the boundary (mirrors the chunked encode). Each segment reads its own
        # switches: a prediction is the same for every reach that covers its
        # vector, and the two-reference path changes nothing without mode 2.
        parts, init = [], None
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            seg = [tuple(a[s:e] for a in plane) for plane in planes]
            recons = _decode_planes(seg, [q[s:e] for q in qps], sizes, dev, bfr=0,
                                    deblock=deblock, init=init)
            init = tuple(_carry(r) for r in recons)
            parts.append(to_rgb(recons))
        return torch.cat(parts), float(fps)


def luma_modes(stream: bytes) -> np.ndarray:
    """Tooling/tests: per-block luma prediction modes ``(N, By, Bx)`` int8
    parsed from a container stream. P-only streams carry MODE_INTRA=0 /
    MODE_INTER=1 (plus MODE_INTER_REF2=2 when encoded with multi_ref, and
    4-6 on spatially predicted intra frames); ``b_frames`` streams
    additionally carry MODE_INTER_BWD=2 / MODE_INTER_BI=3 on odd (B)
    frames."""
    _, has_roi, orig_w, orig_h, n, _, _, _, _, _, off = _read_header(stream)
    buf = memoryview(stream)
    h = orig_h + ((-orig_h) % _PAD)
    w = orig_w + ((-orig_w) % _PAD)
    by, bx = h // BLOCK, w // BLOCK
    if has_roi:
        _, _, off = _unpack_section(buf, off)
    bk_m, pl_m, _ = _unpack_section(buf, off)
    return (
        entropy.decode_bytes(bk_m, pl_m, n * by * bx).reshape(n, by, bx).astype(np.int8)
    )


def section_backends(stream: bytes) -> list:
    """Tooling/tests: the entropy backend id (``entropy.BACKEND_*``, the DPCM
    flag masked off) of every section of a stream, in stream order."""
    _, has_roi, _, _, _, _, _, _, _, _, off = _read_header(stream)
    buf = memoryview(stream)
    backends = []
    for _ in range(int(has_roi) + 9):
        backend, _, off = _unpack_section(buf, off)
        backends.append(backend & ~_DC_DPCM_FLAG)
    assert off == len(stream), "trailing bytes after the last section"
    return backends


class NvcCodec:
    """High-level codec with two-pass bitrate targeting. ``device``: where
    encodes and decodes run and where decoded frames are returned."""

    name = "nvc"

    def __init__(self, device: Device = "cuda"):
        self.device = resolve_device(device)

    def probe(self, stream: bytes) -> NvcStream:
        version, has_roi, orig_w, orig_h, n, fps, base_qp, gop, _, _, _ = (
            _read_header(stream)
        )
        return NvcStream(orig_w, orig_h, n, fps, base_qp, bool(has_roi), len(stream))

    def encode(
        self,
        frames: Frames,
        *,
        qp: Optional[int] = None,
        target_bitrate: Optional[float] = None,
        framerate: float = 30.0,
        roi_delta_qp: Optional[np.ndarray] = None,
        gop: int = 0,
        me_radius: int = 4,
        me_step: int = 1,
        me_halfpel: bool = True,
        b_frames: bool = False,
        b_qp_offset: int = 2,
        multi_ref: bool = False,
        chunk_frames: Optional[int] = None,
        deblock: bool = True,
        intra_pred: bool = True,
    ) -> bytes:
        if (qp is None) == (target_bitrate is None):
            raise ValueError("specify exactly one of qp / target_bitrate")
        kw = dict(framerate=framerate, roi_delta_qp=roi_delta_qp, gop=gop,
                  me_radius=me_radius, me_step=me_step, me_halfpel=me_halfpel,
                  b_frames=b_frames, b_qp_offset=b_qp_offset, multi_ref=multi_ref,
                  chunk_frames=chunk_frames, deblock=deblock,
                  intra_pred=intra_pred, device=self.device)
        if qp is not None:
            return encode(frames, qp=qp, **kw)

        n = frames.shape[0]
        duration = n / framerate
        target_bits = target_bitrate * duration

        qp_probe = 32
        if n >= _PREFIX_PROBE_MIN_FRAMES:
            return self._encode_targeted_prefix(
                frames, target_bits, duration, qp_probe, gop, kw)

        stream = encode(frames, qp=qp_probe, **kw)
        bits = len(stream) * 8
        # bits roughly halve per +6 QP
        qp_est = int(np.clip(round(qp_probe + 6 * np.log2(bits / target_bits)), 0, 51))
        if qp_est == qp_probe:
            return stream
        stream = encode(frames, qp=qp_est, **kw)
        bits2 = len(stream) * 8
        if abs(bits2 - target_bits) / target_bits > 0.15:
            # one refinement step using the locally measured slope
            # bits(q) ~ bits0 * 2^(slope*(q-q0)), slope ~ -1/6
            if bits2 != bits and qp_est != qp_probe:
                slope = np.log2(bits2 / bits) / (qp_est - qp_probe)
                slope = slope if slope < -1e-3 else -1 / 6
            else:
                slope = -1 / 6
            qp_ref = int(
                np.clip(round(qp_est + np.log2(target_bits / bits2) / slope), 0, 51)
            )
            if qp_ref != qp_est:
                stream = encode(frames, qp=qp_ref, **kw)
        return stream

    def _encode_targeted_prefix(self, frames, target_bits, duration,
                                qp_probe, gop, kw) -> bytes:
        """Rate targeting with prefix probes: long clips pay ONE full encode
        instead of 2-3.

        bits(m) is ~affine in m for a fixed intra cadence, so two prefixes
        whose length difference spans exactly one GOP cycle give the steady
        per-frame rate; the per-QP *ratio* needed for refinement is measured
        on a single prefix. A final full-clip safety check re-encodes only
        on a gross (>35%) miss.
        """
        n = frames.shape[0]
        roi = kw.get("roi_delta_qp")

        # prefix increment spans one intra cycle so the fitted per-frame
        # rate carries the gop's intra/inter blend
        unit = int(gop) if 0 < int(gop) <= n // 3 else 8
        k1 = min(8, max(2, n // 8))
        k2 = k1 + unit
        if k2 > n // 2:  # degenerate gop vs clip length: single prefix
            k1, k2 = 0, max(8, n // 8)

        def _enc_prefix(k, q):
            kw_k = dict(kw)
            if roi is not None:
                kw_k["roi_delta_qp"] = roi[:k]
            return len(encode(frames[:k], qp=q, **kw_k)) * 8

        b2_probe = _enc_prefix(k2, qp_probe)
        if k1:
            b1_probe = _enc_prefix(k1, qp_probe)
            per_frame = max((b2_probe - b1_probe) / (k2 - k1), b2_probe / k2 * 0.1)
        else:
            per_frame = b2_probe / k2
        est_probe = b2_probe + per_frame * (n - k2)

        qp_est = int(np.clip(
            round(qp_probe + 6 * np.log2(est_probe / target_bits)), 0, 51))
        qp_final = qp_est
        if qp_est != qp_probe:
            # refine on the measured prefix ratio (one cheap probe)
            b2_est = _enc_prefix(k2, qp_est)
            est_est = est_probe * b2_est / max(b2_probe, 1)
            if abs(est_est - target_bits) / target_bits > 0.15:
                slope = np.log2(b2_est / b2_probe) / (qp_est - qp_probe)
                slope = slope if slope < -1e-3 else -1 / 6
                qp_final = int(np.clip(
                    round(qp_est + np.log2(target_bits / est_est) / slope), 0, 51))

        stream = encode(frames, qp=qp_final, **kw)
        bits = len(stream) * 8
        if abs(bits - target_bits) / target_bits > 0.35:
            # gross miss (prefix unrepresentative): one corrective pass
            qp_corr = int(np.clip(
                round(qp_final + 6 * np.log2(bits / target_bits)), 0, 51))
            if qp_corr != qp_final:
                stream = encode(frames, qp=qp_corr, **kw)
        return stream

    def decode(self, stream: bytes) -> Tuple[torch.Tensor, float]:
        return decode(stream, device=self.device)
