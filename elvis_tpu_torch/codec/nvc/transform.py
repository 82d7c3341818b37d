"""NVC transform/quantization stage, the device half of the codec (port of
``elvis_tpu.codec.nvc.transform``).

Per 8x8 block: DCT -> uniform scalar quantization with per-block QP
(H.264-style Qstep = 2^((QP-4)/6)) -> int16 levels. P frames choose per
block between intra (transform the pixels) and inter (motion-compensated
residual against the previous *reconstructed* frame: full-search integer
motion + half-pel bilinear refinement) by rate-distortion cost; the encoder
runs the same reconstruction the decoder will, so there is no drift.

Where the JAX package scans over frames and over block rows, this module
loops in Python and carries the reconstructions as tensors; the per-frame
flags (intra or not, spatially predicted or not) are host values, so they
cost no synchronisation. The B frames, which JAX maps over, are a batch
axis: every helper takes leading batch dimensions. Everything runs on the
device of the tensors it is given.

Two numbers are pinned so that an encoder on one device and a decoder on
another agree: Qstep comes from a table of 52 float32 values made once in
float64 (``qstep_from_qp``), and the bit estimate ``ceil(log2(l + 1))`` of
an integer level is taken from the float's exponent (``_level_bits``), which
is exact everywhere.

Under ``torch.profiler`` (``elvis_tpu_torch.utils.trace.span``) each frame of
a plane records one span: ``nvc.encode.intra`` or ``nvc.encode.inter`` (with
``nvc.encode.me`` around each motion search) in ``encode_plane``,
``nvc.decode.intra`` (spatially predicted frames) or ``nvc.decode.inter``
in ``decode_plane``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.ops.dct import block_dct2, block_idct2
from elvis_tpu_torch.utils.trace import span

__all__ = [
    "qstep_from_qp",
    "zigzag_order",
    "deblock_plane",
    "encode_plane",
    "decode_plane",
    "encode_plane_b",
    "decode_plane_b",
    "MODE_INTRA",
    "MODE_INTER",
    "MODE_INTER_BWD",
    "MODE_INTER_BI",
]

BLOCK = 8
# B-frame mode-decision cost: "bits" = estimated coefficient + vector bits,
# "l1" = the L1-coefficient proxy. B_MODE_MV_SCALE weighs the per-vector
# charge against the coefficient bits.
B_MODE_COST = "bits"
B_MODE_MV_SCALE = 0.5
MODE_INTRA = 0
MODE_INTER = 1  # forward (previous-reference) prediction
# Mode value 2 is parity-resolved: on B (odd) frames of a b_frames stream it
# is the backward reference; on P-chain frames it is the SECOND-most-recent
# reference (multi-reference P).
MODE_INTER_BWD = 2  # backward (next-reference) prediction, B frames only
MODE_INTER_REF2 = 2  # two-back reference, P frames with multi_ref
MODE_INTER_BI = 3  # bidirectional average, B frames only
# Spatial intra prediction modes (full-intra frames only): the block's
# pixels are predicted from the RECONSTRUCTED pixel rows directly above it
# before the DCT. Mode 0 on an intra frame means "raw" (no prediction).
MODE_INTRA_DC = 4    # constant = mean of the row above
MODE_INTRA_V = 5     # vertical: copy the row above down the block
MODE_INTRA_GRAD = 6  # planar-style: extrapolate the vertical gradient

# Qstep of every QP 0..51, made in float64 and rounded to float32 once: the
# same 52 numbers on every device (an ``exp2`` differs by an ulp or two
# between devices and frameworks, and encoder and decoder would drift apart).
_QSTEP_TABLE = np.exp2((np.arange(52, dtype=np.float64) - 4.0) / 6.0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _qstep_tensor(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_QSTEP_TABLE, device=device)


def qstep_from_qp(qp: torch.Tensor) -> torch.Tensor:
    """Integer QP in [0, 51] -> float32 Qstep, from the table."""
    return _qstep_tensor(qp.device)[qp.long()]


@functools.lru_cache(maxsize=8)
def zigzag_order(b: int = BLOCK) -> np.ndarray:
    """Flat indices of a b x b block in JPEG zigzag order."""
    idx = sorted(
        ((u, v) for u in range(b) for v in range(b)),
        key=lambda uv: (uv[0] + uv[1], uv[1] if (uv[0] + uv[1]) % 2 == 0 else uv[0]),
    )
    return np.asarray([u * b + v for u, v in idx], dtype=np.int32)


def _blocks_of(plane: torch.Tensor) -> torch.Tensor:
    """``(..., H, W)`` -> ``(..., By, Bx, 8, 8)`` (a permuted view)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // BLOCK, BLOCK, w // BLOCK, BLOCK).transpose(-3, -2)


def _plane_of(blocks: torch.Tensor) -> torch.Tensor:
    *lead, by, bx, b, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, by * b, bx * b)


def _level_bits(mag: torch.Tensor, zero_bits: float = 0.05) -> torch.Tensor:
    """The range coder's bit estimate of integer magnitudes (float32):
    ``2 * ceil(log2(l + 1)) + 2`` for l > 0 (sign, adaptive-unary length and
    mantissa), ``zero_bits`` for a coded zero. ``ceil(log2(l + 1))`` of an
    integer l >= 1 is its bit length, which is the exponent ``frexp``
    returns: no device's ``log2`` can move it."""
    length = torch.frexp(mag).exponent.to(mag.dtype)
    return torch.where(mag > 0, 2.0 * length + 2.0, zero_bits)


# RDOQ-lite lambda, in Qstep^2 units. Each coefficient picks between its
# rounded level l0 and l0-1 by D + lambda*R under the range coder's bit
# model; in practice this zeroes isolated |c| < ~0.76*Qstep coefficients and
# leaves multi-level coefficients at full rounding precision. 0 disables.
RDOQ_LAMBDA = 0.133


def _quantize(coeffs: torch.Tensor, qstep: torch.Tensor) -> torch.Tensor:
    # qstep (..., By, Bx) -> broadcast over (..., By, Bx, 8, 8)
    q = qstep[..., None, None]
    a = coeffs.abs()
    l0 = torch.round(a / q)
    if RDOQ_LAMBDA:
        l1 = torch.clamp(l0 - 1.0, min=0.0)
        lam = RDOQ_LAMBDA * q * q
        c0 = (a - l0 * q) ** 2 + lam * _level_bits(l0)
        c1 = (a - l1 * q) ** 2 + lam * _level_bits(l1)
        l0 = torch.where(c1 < c0, l1, l0)
    lv = torch.sign(coeffs) * l0
    return torch.clamp(lv, -32767, 32767).to(torch.int16)


def _dequantize(levels: torch.Tensor, qstep: torch.Tensor) -> torch.Tensor:
    return levels.float() * qstep[..., None, None]


def _rd_cost(levels: torch.Tensor, coeffs: torch.Tensor, qstep: torch.Tensor) -> torch.Tensor:
    """Per-block rate-distortion cost D + lambda*R for mode decision.

    D = transform-domain quantization SSD (orthonormal DCT, so equal to the
    pixel-domain SSD); R = the bit estimate of ``_level_bits``;
    lambda = 0.85 * Qstep^2."""
    rec = levels.float() * qstep[..., None, None]
    dist = ((rec - coeffs) ** 2).sum(dim=(-2, -1))
    bits = _level_bits(levels.abs().float())
    lam = 0.85 * qstep * qstep
    return dist + lam * bits.sum(dim=(-2, -1))


# In-loop deblocking thresholds, in units of the boundary's quantizer step
# (H.264-style weak filter: an edge step SMALLER than the step size is
# indistinguishable from quantization error and safe to smooth).
DEBLOCK_EDGE = 0.8    # max |p0-q0| (in qstep) the filter touches
DEBLOCK_FLAT = 0.4    # max inner-gradient |p1-p0|, |q1-q0|
DEBLOCK_TC = 0.15     # clamp on the correction, in qstep


def _deblock_cols(plane: torch.Tensor, qstep: torch.Tensor) -> torch.Tensor:
    """Filter the VERTICAL block boundaries of planes ``(..., H, W)``.

    ``qstep (..., By, Bx)``. For each boundary column pair p1 p0 | q0 q1 the
    weak filter applies where the edge looks like quantization noise
    relative to the local quantizer step: p0/q0 move toward each other by a
    clamped delta. Returns a new tensor."""
    *lead, h, w = plane.shape
    bx = w // BLOCK
    r = plane.clone(memory_format=torch.contiguous_format).reshape(*lead, h, bx, BLOCK)
    p1, p0 = r[..., :-1, BLOCK - 2], r[..., :-1, BLOCK - 1]
    q0, q1 = r[..., 1:, 0], r[..., 1:, 1]
    qs_rows = qstep.repeat_interleave(BLOCK, dim=-2)[..., :h, :]  # (..., H, Bx)
    qs = 0.5 * (qs_rows[..., :-1] + qs_rows[..., 1:])             # (..., H, Bx-1)
    fit = (
        ((p0 - q0).abs() < DEBLOCK_EDGE * qs)
        & ((p1 - p0).abs() < DEBLOCK_FLAT * qs)
        & ((q1 - q0).abs() < DEBLOCK_FLAT * qs)
    )
    tc = DEBLOCK_TC * qs
    delta = torch.clamp(((q0 - p0) * 4.0 + (p1 - q1)) * 0.125, -tc, tc) * fit
    p0 += delta  # views into the clone
    q0 -= delta
    return r.reshape(*lead, h, w)


def deblock_plane(plane: torch.Tensor, qstep: torch.Tensor) -> torch.Tensor:
    """In-loop deblocking of reconstructed planes ``(..., H, W)``: both
    block-boundary directions, QP-adaptive thresholds. Encoder and decoder
    apply it identically to every reference reconstruction."""
    plane = _deblock_cols(plane, qstep)
    return _deblock_cols(plane.transpose(-2, -1), qstep.transpose(-2, -1)).transpose(-2, -1)


def _intra_predictors(top2: torch.Tensor) -> torch.Tensor:
    """Candidate spatial predictions from the two reconstructed pixel rows
    directly above each block.

    ``top2 (Bx, 2, b)`` (``top2[:, 1]`` is the adjacent row, ``top2[:, 0]``
    the one above it) -> ``(4, Bx, b, b)``: [raw (zeros), DC, vertical,
    gradient]. Prediction uses UN-deblocked reconstructions, which is what
    the encode and decode wavefronts carry."""
    bx = top2.shape[0]
    t1, t0 = top2[:, 1], top2[:, 0]
    shape = (bx, BLOCK, BLOCK)
    none = torch.zeros(shape, dtype=torch.float32, device=top2.device)
    dc = t1.mean(dim=-1)[:, None, None].expand(shape)
    vert = t1[:, None, :].expand(shape)
    r = torch.arange(1, BLOCK + 1, dtype=torch.float32, device=top2.device)[None, :, None]
    grad = torch.clamp(t1[:, None, :] + r * (t1 - t0)[:, None, :], 0.0, 255.0)
    return torch.stack([none, dc, vert, grad])


def _select(stacked: torch.Tensor, index: torch.Tensor, trailing: int) -> torch.Tensor:
    """``stacked (K, *S, *T)``, ``index (*S)`` in [0, K) -> ``(*S, *T)``: the
    candidate ``index`` picks per position (``T`` has ``trailing`` dims)."""
    idx = index.long()[(None, ...) + (None,) * trailing]
    return torch.gather(stacked, 0, idx.expand(1, *stacked.shape[1:]))[0]


def _top0(bx: int, device) -> torch.Tensor:
    return torch.full((bx, 2, BLOCK), 128.0, dtype=torch.float32, device=device)


def _intra_frame_encode(blocks: torch.Tensor, qs: torch.Tensor):
    """Spatially-predicted encode of one full-intra frame.

    A wavefront over BLOCK ROWS (By sequential steps, each over the Bx
    blocks of the row): every block predicts from the reconstructed bottom
    rows of the block above, so the top-referencing modes need no per-block
    sequencing.

    blocks ``(By, Bx, b, b)``, qs ``(By, Bx)`` -> (levels int16
    ``(By, Bx, b, b)``, modes int8 ``(By, Bx)`` in {0, MODE_INTRA_DC,
    MODE_INTRA_V, MODE_INTRA_GRAD}, recon blocks float32). Mode selection is
    the D+lambda*R rule of the inter mode decision (_rd_cost)."""
    by, bx = blocks.shape[:2]
    top2 = _top0(bx, blocks.device)
    lv_rows, mode_rows, rec_rows = [], [], []
    for row in range(by):
        blk, qr = blocks[row], qs[row]  # (Bx,b,b), (Bx,)
        preds = _intra_predictors(top2)  # (4,Bx,b,b)
        cs = block_dct2(blk[None] - preds)
        lvs = _quantize(cs, qr[None])
        midx = torch.argmin(_rd_cost(lvs, cs, qr[None]), dim=0)  # (Bx,)
        lv = _select(lvs, midx, 2)
        pred = _select(preds, midx, 2)
        rec = torch.clamp(block_idct2(lv.float() * qr[:, None, None]) + pred, 0.0, 255.0)
        top2 = rec[:, -2:, :]
        lv_rows.append(lv)
        mode_rows.append(torch.where(midx == 0, 0, midx + 3).to(torch.int8))
        rec_rows.append(rec)
    return torch.stack(lv_rows), torch.stack(mode_rows), torch.stack(rec_rows)


def _intra_frame_rd(lv, blocks, rec, qs, modes) -> torch.Tensor:
    """FRAME-level cost of one intra-frame candidate, for the
    raw-vs-spatially-predicted arbiter in encode_plane.

    Mixing raw and predicted blocks fragments the DC-DPCM stream (the
    container codes each DC as the delta to the previous block in raster
    order), so a block's true DC cost depends on its neighbours' modes. At
    frame level both candidates' bits are computable: AC bits by the bit
    model, DC bits over the in-frame DPCM sequence, and the mode plane at
    its empirical entropy."""
    dist = ((rec - blocks) ** 2).sum(dim=(-2, -1))  # (By,Bx)
    lvf = lv.float()
    mag = lvf.abs()
    mag[..., 0, 0] = 0.0
    bits_ac = _level_bits(mag).sum(dim=(-2, -1))
    dc = lvf[..., 0, 0].reshape(-1)  # frame raster order
    dcd = (dc - torch.cat([dc.new_zeros(1), dc[:-1]])).abs()
    bits_dc = _level_bits(dcd)
    counts = torch.stack(
        [(modes == v).sum() for v in (0, MODE_INTRA_DC, MODE_INTRA_V, MODE_INTRA_GRAD)]
    ).float()
    p = counts / torch.clamp(counts.sum(), min=1.0)
    ent = -torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-12)), 0.0).sum()
    lam = 0.85 * qs * qs
    return (
        (dist + lam * bits_ac).sum()
        + (lam.reshape(-1) * bits_dc).sum()
        + lam.mean() * ent * counts.sum()
    )


def _intra_frame_decode(lvl: torch.Tensor, mode: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Decode-side wavefront, the mirror of _intra_frame_encode: lvl
    ``(By, Bx, b, b)`` float32 levels, mode ``(By, Bx)``, qs ``(By, Bx)`` ->
    reconstructed blocks ``(By, Bx, b, b)``."""
    by, bx = lvl.shape[:2]
    midx = torch.where(mode >= 4, mode.long() - 3, 0)
    res = block_idct2(lvl * qs[..., None, None])  # the residuals need no wavefront
    top2 = _top0(bx, lvl.device)
    rows = []
    for row in range(by):
        pred = _select(_intra_predictors(top2), midx[row], 2)
        rec = torch.clamp(res[row] + pred, 0.0, 255.0)
        top2 = rec[:, -2:, :]
        rows.append(rec)
    return torch.stack(rows)


def _pad_edge(x: torch.Tensor, pad) -> torch.Tensor:
    """Edge-replicate pad of the last two dims of ``(..., H, W)``;
    ``pad = (left, right, top, bottom)``."""
    *lead, h, w = x.shape
    y = F.pad(x.reshape(-1, 1, h, w), pad, mode="replicate")
    return y.reshape(*lead, y.shape[-2], y.shape[-1])


def _block_sad(cur: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-block sum of absolute differences of two ``(..., By, Bx, 8, 8)``."""
    return (cur - pred).abs().sum(dim=(-2, -1))


@functools.lru_cache(maxsize=32)
def _search_offsets(radius: int, step: int, device: torch.device):
    """The search grid, dy outer and dx inner: as a list of pairs for the
    host's loop and as a ``(K, 2)`` int32 tensor on ``device``."""
    grid = range(-radius, radius + 1, step)
    pairs = [(dy, dx) for dy in grid for dx in grid]
    return pairs, torch.tensor(pairs, dtype=torch.int32, device=device)


def _motion_search(prev_recon: torch.Tensor, cur_blocks: torch.Tensor, radius: int, step: int):
    """Full-search block motion on the previous reconstruction.

    prev_recon ``(..., H, W)``, cur_blocks ``(..., By, Bx, b, b)`` ->
    mv ``(..., By, Bx, 2)`` int32 (dy, dx) minimizing per-block SAD, the
    first of equal candidates. The candidate offsets are a static grid,
    evaluated as whole-frame shifts of the edge-replicated reference (so a
    shift clamps at the frame border, the pixels _motion_predict reads)
    with per-block reductions."""
    pairs, offsets = _search_offsets(radius, step, prev_recon.device)
    h, w = prev_recon.shape[-2:]
    padded = _pad_edge(prev_recon, (radius,) * 4)
    sads = []
    for dy, dx in pairs:
        shifted = padded[..., radius + dy: radius + dy + h, radius + dx: radius + dx + w]
        sads.append(_block_sad(cur_blocks, _blocks_of(shifted)))
    best = torch.argmin(torch.stack(sads, dim=-1), dim=-1)  # (...,By,Bx)
    return offsets[best]


@functools.lru_cache(maxsize=8)
def _mc_selection_table(b: int = BLOCK, reach: int = 1) -> np.ndarray:
    """(2*R2+1, b, window) selection/averaging matrices, R2 = 2*reach*b.

    ``reach`` is the prediction neighbourhood radius in BLOCKS: the window
    spans (2*reach+1) blocks and represents half-pel motion components up to
    |m| = 2*reach*b. Entry for half-pel component m maps a length-``window``
    neighbourhood row (centred so index reach*b corresponds to the block's
    own first pel) to the b output pels at offset m/2: a single 1 for even
    m, two 0.5 taps for odd m (bilinear half-pel)."""
    window = (2 * reach + 1) * b
    r2 = 2 * reach * b
    table = np.zeros((2 * r2 + 1, b, window), dtype=np.float64)
    for mi, m in enumerate(range(-r2, r2 + 1)):
        base = m // 2  # floor division
        frac = m - 2 * base  # 0 or 1
        for u in range(b):
            p0 = min(max(reach * b + u + base, 0), window - 1)
            if frac == 0:
                table[mi, u, p0] = 1.0
            else:
                p1 = min(p0 + 1, window - 1)
                table[mi, u, p0] += 0.5
                table[mi, u, p1] += 0.5
    return table


@functools.lru_cache(maxsize=16)
def _mc_table_tensor(reach: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_mc_selection_table(BLOCK, reach), dtype=torch.float32,
                           device=device)


def _neighbourhood(prev_recon: torch.Tensor, reach: int = 1) -> torch.Tensor:
    """``(..., By, Bx, W, W)`` block neighbourhoods, W = (2*reach+1)*BLOCK:
    each block's surrounding (2*reach+1)^2 block window, edge blocks
    replicated (out-of-frame motion clamps at BLOCK granularity).

    The tensor is (2*reach+1)^2 copies of the frame in float32; keep reach
    <= 3 on large frames (the hierarchical search covers long motion
    coarse-to-fine so that a large reach is not needed at full size)."""
    blocks = _blocks_of(prev_recon)  # (...,By,Bx,b,b)
    *lead, by, bx, b, _ = blocks.shape
    win = (2 * reach + 1) * b
    nb = blocks.new_empty(*lead, by, bx, win, win)
    iy = torch.arange(by, device=blocks.device)
    ix = torch.arange(bx, device=blocks.device)
    for i, di in enumerate(range(-reach, reach + 1)):
        rows = blocks.index_select(-4, torch.clamp(iy + di, 0, by - 1))
        for j, dj in enumerate(range(-reach, reach + 1)):
            nb[..., i * b:(i + 1) * b, j * b:(j + 1) * b] = rows.index_select(
                -3, torch.clamp(ix + dj, 0, bx - 1))
    return nb


def _predict_from_nb(nb: torch.Tensor, mv2: torch.Tensor, reach: int = 1) -> torch.Tensor:
    """MC prediction from a prebuilt neighbourhood (shared across the
    refinement candidates so the neighbourhood is built once):
    ``pred = R[mv_y] @ NB @ R[mv_x].T`` in full float32. Each output pel is
    one pixel or the mean of two or four, so the result is the same bits on
    every device."""
    r2 = 2 * reach * BLOCK
    table = _mc_table_tensor(reach, nb.device)
    my = torch.clamp(mv2[..., 0], -r2, r2).long() + r2
    mx = torch.clamp(mv2[..., 1], -r2, r2).long() + r2
    ry = table[my]  # (...,By,Bx,b,W)
    rx = table[mx]
    with full_fp32():
        return torch.matmul(torch.matmul(ry, nb), rx.transpose(-2, -1))


def _motion_predict(prev_recon: torch.Tensor, mv2: torch.Tensor, reach: int = 1) -> torch.Tensor:
    """Per-block motion-compensated prediction at HALF-PEL resolution.

    prev_recon ``(..., H, W)``, mv2 ``(..., By, Bx, 2)`` in half-pel units
    -> pred blocks ``(..., By, Bx, b, b)``. Out-of-frame motion clamps at
    BLOCK granularity (edge blocks replicate). The prediction for an
    in-range mv2 is identical for every reach that represents it, so encoder
    and decoder only need |mv2| <= 2*reach*BLOCK each."""
    return _predict_from_nb(_neighbourhood(prev_recon, reach), mv2, reach)


@functools.lru_cache(maxsize=8)
def _nine_offsets(device: torch.device) -> torch.Tensor:
    return torch.tensor([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        dtype=torch.int32, device=device)


def _refine(nb, cur_blocks, centre, reach, step):
    """The SAD minimizer among the 9 vectors ``centre + step * {-1,0,1}^2``
    (the first of equal ones); ``centre`` and ``step`` in half-pel units."""
    offs = _nine_offsets(centre.device) * step
    cands = centre[None] + offs.reshape(9, *(1,) * (centre.dim() - 1), 2)
    sads = [_block_sad(cur_blocks, _predict_from_nb(nb, c, reach)) for c in cands]
    best = torch.argmin(torch.stack(sads, dim=-1), dim=-1)  # (...,By,Bx)
    return _select(cands, best, 1)


def _integer_refine(
    prev_recon: torch.Tensor,
    cur_blocks: torch.Tensor,
    mv_int: torch.Tensor,
    reach: int = 1,
    rounds: int = 1,
) -> torch.Tensor:
    """``rounds`` greedy +-1 full-pel refinement steps around a coarse
    integer vector (the fine stage of the coarse-to-fine search)."""
    nb = _neighbourhood(prev_recon, reach)
    mv2 = mv_int * 2
    for _ in range(rounds):
        mv2 = _refine(nb, cur_blocks, mv2, reach, step=2)
    return mv2 // 2  # always even


def _halfpel_refine(
    prev_recon: torch.Tensor,
    cur_blocks: torch.Tensor,
    mv_int: torch.Tensor,
    reach: int = 1,
) -> torch.Tensor:
    """Refine integer motion to half-pel: evaluate the 9 half-pel candidates
    around each block's integer vector, keep the SAD minimizer. Returns mv
    in half-pel units ``(..., By, Bx, 2)`` int32."""
    return _refine(_neighbourhood(prev_recon, reach), cur_blocks, mv_int * 2, reach, step=1)


def _me_plan(me_radius: int):
    """Static search plan for a given radius: (coarse_factor, refine_rounds,
    reach). Radii <= 7 use the dense single-level search; larger radii
    search a 2^k-area-downsampled frame and recover precision with greedy
    +-1 refinement."""
    if me_radius <= 7:
        return 1, 0, 1
    factor = 2
    while -(-me_radius // factor) > 5:
        factor *= 2
    rounds = min(3, factor // 2)
    max_mv = factor * (-(-me_radius // factor)) + rounds + 1
    reach = max(1, -(-max_mv // BLOCK))
    return factor, rounds, reach


def _coarse_motion(
    prev_recon: torch.Tensor, cur_plane: torch.Tensor, radius: int, factor: int
) -> torch.Tensor:
    """Full search on a ``factor``-x area-downsampled frame pair; returns
    full-res per-block integer vectors (each coarse block's vector is shared
    by its factor^2 children, scaled back up)."""
    h, w = prev_recon.shape[-2:]
    ph = (-h) % (BLOCK * factor)
    pw = (-w) % (BLOCK * factor)
    if ph or pw:
        prev_recon = _pad_edge(prev_recon, (0, pw, 0, ph))
        cur_plane = _pad_edge(cur_plane, (0, pw, 0, ph))
    hp, wp = h + ph, w + pw

    def ds(x):
        return x.reshape(*x.shape[:-2], hp // factor, factor, wp // factor,
                         factor).mean(dim=(-3, -1))

    rc = -(-radius // factor)
    mv_c = _motion_search(ds(prev_recon), _blocks_of(ds(cur_plane)), rc, 1)
    mv = mv_c.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2) * factor
    return mv[..., : h // BLOCK, : w // BLOCK, :]


def _search_mv(
    recon_ref: torch.Tensor,
    blocks: torch.Tensor,
    me_radius: int,
    me_step: int,
    me_halfpel: bool,
    factor: int,
    rounds: int,
    reach: int,
) -> torch.Tensor:
    """Full ME pipeline against one reference: (coarse) search + integer
    refinement + optional half-pel, clamped to the reach's representable
    (and the container's int8) half-pel range."""
    with span("nvc.encode.me"):
        if factor == 1:
            mv_int = _motion_search(recon_ref, blocks, me_radius, me_step)
        else:
            mv_int = _coarse_motion(recon_ref, _plane_of(blocks), me_radius, factor)
            mv_int = _integer_refine(recon_ref, blocks, mv_int, reach=reach, rounds=rounds)
        if me_halfpel:
            mv = _halfpel_refine(recon_ref, blocks, mv_int, reach=reach)
        else:
            mv = mv_int * 2  # integer motion in half-pel units
    # Stored vectors must stay inside THIS reach's representable range (and
    # the container's int8 half-pel range): the decoder sizes its tables
    # from the stream's max |mv| and predictions agree for every reach that
    # covers it.
    lim = min(2 * reach * BLOCK, 126)
    return torch.clamp(mv, -lim, lim)


def _zero_mv(blocks: torch.Tensor) -> torch.Tensor:
    return torch.zeros(blocks.shape[:-2] + (2,), dtype=torch.int32, device=blocks.device)


def _init_carry(init_recon, h, w, device):
    if init_recon is None:
        zero = torch.zeros((h, w), dtype=torch.float32, device=device)
        return zero, zero
    return (torch.as_tensor(init_recon[0], dtype=torch.float32, device=device),
            torch.as_tensor(init_recon[1], dtype=torch.float32, device=device))


def _force_intra_flags(n: int, gop: int, frame_offset: int) -> list:
    t_idx = np.arange(n) + frame_offset
    return ((t_idx == 0) if gop <= 0 else (t_idx % gop == 0)).tolist()


def encode_plane(
    plane: torch.Tensor,
    qp_map: torch.Tensor,
    gop: int = 0,
    me_radius: int = 4,
    me_step: int = 1,
    me_halfpel: bool = True,
    force_intra: Optional[Sequence[bool]] = None,
    multi_ref: bool = False,
    frame_offset: int = 0,
    init_recon: Optional[tuple] = None,
    deblock: bool = False,
    intra_pred: bool = True,
):
    """plane ``(N, H, W)`` float32 [0,255]; qp_map ``(N, By, Bx)`` int.

    Returns (levels (N,By,Bx,64) int16 in raster coefficient order, modes
    (N,By,Bx) int8, mv (N,By,Bx,2) int8 in HALF-PEL units, recon (N,H,W)
    float32), on the plane's device.

    ``gop``: intra-frame period (0 = only frame 0 is intra).
    ``intra_pred``: spatial intra prediction on full-intra frames
    (_intra_frame_encode; modes {0, 4, 5, 6} appear there). False gives
    raw-DCT keyframes.
    ``me_radius/me_step``: motion-search grid (0 radius = zero-motion).
    Radii above 7 switch to the hierarchical coarse-to-fine search
    (_me_plan), with the prediction neighbourhood widened to match.
    ``multi_ref``: per-block selection between the previous and the TWO-BACK
    reconstruction (mode MODE_INTER_REF2; searched at 2x the per-frame
    radius since the content moved two frames). The decoder handles mode 2
    without a header flag.
    ``force_intra``: host booleans, one per frame, overriding ``gop``.
    ``frame_offset``/``init_recon``: CHUNKED encoding. ``frame_offset`` is
    this segment's first global frame index (keeps the gop phase and the
    frame-0 intra rule); ``init_recon`` is the ``(prev, prev2)``
    reconstruction carry from the previous segment. Chunked output equals
    the single-loop encode exactly.
    """
    if me_radius > 56:
        raise ValueError(
            f"me_radius={me_radius} exceeds the int8 half-pel motion "
            "container range (max supported radius: 56)"
        )
    n, h, w = plane.shape
    factor, rounds, reach = _me_plan(me_radius)
    radius2 = min(2 * me_radius, 56)
    factor2, rounds2, reach2 = _me_plan(radius2)
    qstep = qstep_from_qp(qp_map)  # (N,By,Bx)
    frames_blocks = _blocks_of(plane.float())  # (N,By,Bx,8,8)
    if force_intra is None:
        force_intra = _force_intra_flags(n, gop, frame_offset)
    else:
        force_intra = [bool(f) for f in force_intra]

    def finish(rec_blocks, qs):
        recon = _plane_of(rec_blocks)
        return deblock_plane(recon, qs) if deblock else recon

    def raw_intra(blocks, qs):
        lv = _quantize(block_dct2(blocks), qs)
        return lv, torch.clamp(block_idct2(_dequantize(lv, qs)), 0.0, 255.0)

    def intra_frame(blocks, qs):
        lv_raw, rec_raw = raw_intra(blocks, qs)
        md_raw = torch.zeros(blocks.shape[:2], dtype=torch.int8, device=blocks.device)
        if intra_pred:
            # the spatially-predicted wavefront, and the frame-level arbiter
            # against the raw alternative: content where top-row prediction
            # only fragments the DC-DPCM stream (dense texture) stays raw
            lv_sp, md_sp, rec_sp = _intra_frame_encode(blocks, qs)
            use_sp = (_intra_frame_rd(lv_sp, blocks, rec_sp, qs, md_sp)
                      < _intra_frame_rd(lv_raw, blocks, rec_raw, qs, md_raw))
            lv = torch.where(use_sp, lv_sp, lv_raw)
            md = torch.where(use_sp, md_sp, md_raw)
            rec = torch.where(use_sp, rec_sp, rec_raw)
        else:
            lv, md, rec = lv_raw, md_raw, rec_raw
        return lv, md, _zero_mv(blocks).to(torch.int8), finish(rec, qs)

    def inter_frame(recon_prev, recon_prev2, blocks, qs):
        if me_radius > 0:
            mv = _search_mv(recon_prev, blocks, me_radius, me_step, me_halfpel,
                            factor, rounds, reach)
        else:
            mv = _zero_mv(blocks)
        pred = _motion_predict(recon_prev, mv, reach=reach)  # (By,Bx,8,8)

        c_intra = block_dct2(blocks)
        c_inter = block_dct2(blocks - pred)
        lv_intra = _quantize(c_intra, qs)
        lv_inter = _quantize(c_inter, qs)
        cost_intra = _rd_cost(lv_intra, c_intra, qs)
        cost_inter = _rd_cost(lv_inter, c_inter, qs)

        if multi_ref:
            if me_radius > 0:
                mv2 = _search_mv(recon_prev2, blocks, radius2, me_step, me_halfpel,
                                 factor2, rounds2, reach2)
            else:
                mv2 = _zero_mv(blocks)
            pred2 = _motion_predict(recon_prev2, mv2, reach=reach2)
            c_inter2 = block_dct2(blocks - pred2)
            lv_inter2 = _quantize(c_inter2, qs)
            cost_inter2 = _rd_cost(lv_inter2, c_inter2, qs)
            # intra wins ties
            mode = torch.argmin(torch.stack([cost_intra, cost_inter, cost_inter2], dim=-1),
                                dim=-1)
            lv = _select(torch.stack([lv_intra, lv_inter, lv_inter2]), mode, 2)
            pred_sel = _select(torch.stack([torch.zeros_like(pred), pred, pred2]), mode, 2)
            mv = _select(torch.stack([torch.zeros_like(mv), mv, mv2]), mode, 1)
            rec = torch.clamp(block_idct2(_dequantize(lv, qs)) + pred_sel, 0.0, 255.0)
            return lv, mode.to(torch.int8), mv.to(torch.int8), finish(rec, qs)

        use_inter = cost_inter <= cost_intra
        lv = torch.where(use_inter[..., None, None], lv_inter, lv_intra)
        mv = torch.where(use_inter[..., None], mv, 0)
        rec_res = block_idct2(_dequantize(lv, qs))
        rec = torch.where(use_inter[..., None, None], rec_res + pred, rec_res)
        rec = torch.clamp(rec, 0.0, 255.0)
        return lv, use_inter.to(torch.int8), mv.to(torch.int8), finish(rec, qs)

    recon_prev, recon_prev2 = _init_carry(init_recon, h, w, plane.device)
    out = []
    for t in range(n):
        if force_intra[t]:
            with span("nvc.encode.intra"):
                frame = intra_frame(frames_blocks[t], qstep[t])
        else:
            with span("nvc.encode.inter"):
                frame = inter_frame(recon_prev, recon_prev2, frames_blocks[t], qstep[t])
        recon_prev, recon_prev2 = frame[3], recon_prev
        out.append(frame)
    levels, modes, mvs, recons = (torch.stack(parts) for parts in zip(*out))
    by, bx = levels.shape[1], levels.shape[2]
    return levels.reshape(n, by, bx, BLOCK * BLOCK), modes, mvs, recons


def _spatial_flags(modes) -> list:
    """Per frame: does any block carry a spatial intra mode (>= 4)? Such a
    frame is a spatially-predicted full-intra frame (encode_plane only emits
    the modes there). Costs one synchronisation when ``modes`` is a device
    tensor; the container passes the flags from its host copy instead."""
    m = modes.cpu().numpy() if isinstance(modes, torch.Tensor) else np.asarray(modes)
    return (m.reshape(m.shape[0], -1) >= 4).any(axis=1).tolist()


def decode_plane(
    levels: torch.Tensor,
    modes: torch.Tensor,
    mvs: torch.Tensor,
    qp_map: torch.Tensor,
    h: int,
    w: int,
    reach: int = 1,
    multi_ref: bool = False,
    init_recon: Optional[tuple] = None,
    deblock: bool = False,
    spatial: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """Inverse of encode_plane: levels ``(N,By,Bx,64)``, modes ``(N,By,Bx)``,
    mvs ``(N,By,Bx,2)``, qp_map ``(N,By,Bx)`` -> plane ``(N,H,W)`` float32.
    ``reach`` must cover the stream's max |mv| (the container derives it
    host-side: ceil(max|mv2|/16)). ``multi_ref``: honour MODE_INTER_REF2
    blocks (prediction from the two-back reconstruction); the container sets
    it iff mode 2 appears on P frames. ``spatial``: host booleans, one per
    frame, True where the frame holds spatial intra modes (default: read
    from ``modes``)."""
    n, by, bx, _ = levels.shape
    qstep = qstep_from_qp(qp_map)
    lv = levels.reshape(n, by, bx, BLOCK, BLOCK).float()
    if spatial is None:
        spatial = _spatial_flags(modes)
    recon_prev, recon_prev2 = _init_carry(init_recon, h, w, levels.device)
    recons = []
    for t in range(n):
        lvl, mode, qs = lv[t], modes[t], qstep[t]
        with span("nvc.decode.intra" if spatial[t] else "nvc.decode.inter"):
            if spatial[t]:
                recon = _plane_of(_intra_frame_decode(lvl, mode, qs))
            else:
                mv = mvs[t].int()
                pred = _motion_predict(recon_prev, mv, reach=reach)
                if multi_ref:
                    pred2 = _motion_predict(recon_prev2, mv, reach=reach)
                    pred = torch.where((mode == MODE_INTER_REF2)[..., None, None], pred2, pred)
                    is_inter = (mode == MODE_INTER) | (mode == MODE_INTER_REF2)
                else:
                    is_inter = mode == MODE_INTER
                rec_res = block_idct2(lvl * qs[..., None, None])
                rec = torch.where(is_inter[..., None, None], rec_res + pred, rec_res)
                recon = _plane_of(torch.clamp(rec, 0.0, 255.0))
            if deblock:
                recon = deblock_plane(recon, qs)
        recon_prev, recon_prev2 = recon, recon_prev
        recons.append(recon)
    return torch.stack(recons)


# B frames are never referenced, so all of a clip's B frames could go through
# one batch; the batch is cut so that the 9-copy prediction neighbourhoods of
# one step stay near this many luma pixels.
_B_BATCH_PIXELS = 1 << 24


def _b_batches(nb: int, h: int, w: int):
    step = max(1, _B_BATCH_PIXELS // (h * w))
    return [(s, min(s + step, nb)) for s in range(0, nb, step)]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Display order: ``even`` frames at 0, 2, ..., ``odd`` ones between."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[::2] = even
    out[1::2] = odd
    return out


def _b_references(rec_e: torch.Tensor, s: int, e: int):
    """References of B frames ``s..e`` (frame 2k+1 lies between even frames
    k and k+1; at the tail the forward reference serves twice)."""
    k = torch.arange(s, e, device=rec_e.device)
    return rec_e[k], rec_e[torch.clamp(k + 1, max=rec_e.shape[0] - 1)]


def encode_plane_b(
    plane: torch.Tensor,
    qp_map: torch.Tensor,
    gop: int = 0,
    me_radius: int = 4,
    me_step: int = 1,
    me_halfpel: bool = True,
    b_qp_offset: int = 2,
    multi_ref: bool = False,
    deblock: bool = False,
    intra_pred: bool = True,
):
    """B-frame GOP structure: even-index frames form the P-reference chain
    (sequential, exactly encode_plane's loop) and every odd-index frame is a
    B frame bi-predicted from its two neighbouring references. B frames are
    never referenced, so they encode as a batch.

    Per B block the mode is chosen among intra / forward / backward /
    bidirectional (MODE_*).

    Returns (levels (N,By,Bx,64) int16, modes (N,By,Bx) int8, mvs
    (N,By,Bx,2,2) int8 half-pel [fwd, bwd] (P frames store their vector in
    the fwd slot with bwd=0), recon (N,H,W) float32).

    ``me_radius`` is the per-DISPLAY-FRAME motion budget: the reference
    chain steps 2 frames at a time, so it searches 2*me_radius; B frames are
    1 frame from each reference and search me_radius.
    """
    n, h, w = plane.shape
    ref_radius = min(2 * me_radius, 56) if me_radius > 0 else 0
    factor, rounds, reach = _me_plan(me_radius)
    ne = (n + 1) // 2
    nb = n // 2

    # Intra refresh lives on the reference chain: even frame 2k is intra
    # when a gop boundary was crossed since the previous reference.
    fi = np.zeros(ne, bool)
    fi[0] = True
    if gop > 0:
        te = 2 * np.arange(ne)
        fi[1:] = (te[1:] // gop) != (te[:-1] // gop)
    lv_e, md_e, mv_e, rec_e = encode_plane(
        plane[::2], qp_map[::2], gop=0, me_radius=ref_radius, me_step=me_step,
        me_halfpel=me_halfpel, force_intra=fi.tolist(), multi_ref=multi_ref,
        deblock=deblock, intra_pred=intra_pred,
    )
    by, bx = qp_map.shape[1], qp_map.shape[2]
    mv_e = torch.stack([mv_e, torch.zeros_like(mv_e)], dim=-2)  # (ne,By,Bx,2,2)
    if not nb:
        return lv_e, md_e, mv_e, rec_e

    def encode_b(rf, rb, blocks, qs):
        """One batch of B frames: every argument has a leading frame axis."""
        if me_radius > 0:
            mvf = _search_mv(rf, blocks, me_radius, me_step, me_halfpel, factor, rounds, reach)
            mvb = _search_mv(rb, blocks, me_radius, me_step, me_halfpel, factor, rounds, reach)
        else:
            mvf = _zero_mv(blocks)
            mvb = torch.zeros_like(mvf)
        pf = _motion_predict(rf, mvf, reach=reach)
        pb = _motion_predict(rb, mvb, reach=reach)
        preds = torch.stack([torch.zeros_like(pf), pf, pb, 0.5 * (pf + pb)])  # (4,K,By,Bx,b,b)
        lvs = torch.stack([_quantize(block_dct2(blocks - p), qs) for p in preds])
        if B_MODE_COST == "bits":
            # B frames are never referenced, so at fixed QP the distortion
            # across modes is bounded by quantization: the objective is the
            # estimated coefficient bits plus the bits of each active list's
            # vector.
            cbits = _level_bits(lvs.abs().float()).sum(dim=(-2, -1))  # (4,K,By,Bx)

            def mvbits(v):
                return _level_bits(v.abs().float(), zero_bits=0.2).sum(dim=-1)

            bf, bb = mvbits(mvf), mvbits(mvb)
            costs = cbits + B_MODE_MV_SCALE * torch.stack([torch.zeros_like(bf), bf, bb, bf + bb])
        else:
            costs = lvs.abs().sum(dim=(-2, -1))
        mode = torch.argmin(costs, dim=0)  # (K,By,Bx)
        lv = _select(lvs, mode, 2)
        pred = _select(preds, mode, 2)
        use_f = (mode == MODE_INTER) | (mode == MODE_INTER_BI)
        use_b = (mode == MODE_INTER_BWD) | (mode == MODE_INTER_BI)
        mvf = torch.where(use_f[..., None], mvf, 0)
        mvb = torch.where(use_b[..., None], mvb, 0)
        rec = _plane_of(torch.clamp(block_idct2(_dequantize(lv, qs)) + pred, 0.0, 255.0))
        if deblock:
            # display-only filtering, mirrored by decode_plane_b
            rec = deblock_plane(rec, qs)
        return (lv.reshape(*lv.shape[:-2], BLOCK * BLOCK), mode.to(torch.int8),
                torch.stack([mvf, mvb], dim=-2).to(torch.int8), rec)

    blocks_b = _blocks_of(plane[1::2].float())
    # B frames are quantized b_qp_offset coarser (bits drop, nothing propagates)
    qs_b = qstep_from_qp(torch.clamp(qp_map[1::2] + b_qp_offset, 0, 51))
    parts = []
    for s, e in _b_batches(nb, h, w):
        rf, rb = _b_references(rec_e, s, e)
        parts.append(encode_b(rf, rb, blocks_b[s:e], qs_b[s:e]))
    lv_b, md_b, mv_b, rec_b = (torch.cat(p) for p in zip(*parts))
    return (_interleave(lv_e, lv_b), _interleave(md_e, md_b), _interleave(mv_e, mv_b),
            _interleave(rec_e, rec_b))


def decode_plane_b(
    levels: torch.Tensor,
    modes: torch.Tensor,
    mvs: torch.Tensor,
    qp_map: torch.Tensor,
    h: int,
    w: int,
    reach: int = 1,
    b_qp_offset: int = 2,
    multi_ref: bool = False,
    deblock: bool = False,
    spatial: Optional[Sequence[bool]] = None,
) -> torch.Tensor:
    """Inverse of encode_plane_b: mvs ``(N,By,Bx,2,2)`` [fwd, bwd] half-pel.
    Even frames decode as the sequential reference chain (``multi_ref`` iff
    mode 2 appears there), odd (B) frames decode as batches from their two
    references. ``spatial``: as in decode_plane, one flag per frame of the
    clip."""
    n, by, bx, _ = levels.shape
    nb = n // 2
    if spatial is None:
        spatial = _spatial_flags(modes)
    rec_e = decode_plane(
        levels[::2], modes[::2], mvs[::2, :, :, 0, :], qp_map[::2], h, w,
        reach=reach, multi_ref=multi_ref, deblock=deblock, spatial=list(spatial)[::2],
    )
    if not nb:
        return rec_e
    qs_b = qstep_from_qp(torch.clamp(qp_map[1::2] + b_qp_offset, 0, 51))
    lv_b = levels[1::2].reshape(nb, by, bx, BLOCK, BLOCK).float()
    md_b, mv_b = modes[1::2], mvs[1::2].int()
    parts = []
    for s, e in _b_batches(nb, h, w):
        rf, rb = _b_references(rec_e, s, e)
        pf = _motion_predict(rf, mv_b[s:e, :, :, 0, :], reach=reach)
        pb = _motion_predict(rb, mv_b[s:e, :, :, 1, :], reach=reach)
        preds = torch.stack([torch.zeros_like(pf), pf, pb, 0.5 * (pf + pb)])
        pred = _select(preds, md_b[s:e], 2)
        qs = qs_b[s:e]
        rec = _plane_of(torch.clamp(block_idct2(lv_b[s:e] * qs[..., None, None]) + pred,
                                    0.0, 255.0))
        parts.append(deblock_plane(rec, qs) if deblock else rec)
    return _interleave(rec_e, torch.cat(parts))
