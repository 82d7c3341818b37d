"""Block-matching motion estimation (port of ``elvis_tpu.ops.motion``).

Serves the FVMD-style motion metric (``metrics.fvmd``) and the encoder-side
motion hint of the removal branch (``motion_hint`` on the server,
``motion_field_from_hint`` on the client). The (2R+1)^2 candidate offsets
are a loop of whole-frame shifts with per-block SAD reductions.

Medians over an even count are the mean of the two middle values, as
``jnp.median`` / ``jnp.nanmedian`` give them (``torch.median`` would give
the lower one): ``_median`` and ``_nanmedian`` sort and average.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from elvis_tpu_torch.core.blocks import blockwise_reduce, upsample_map

__all__ = ["block_motion", "block_motion_pyramid", "pyramid_range",
           "field_sad", "median3_field", "subpel_refine", "motion_hint",
           "motion_field_from_hint"]


def pyramid_range(radius: int, levels: int, refine_radius: int = 2) -> int:
    """Maximum displacement (px) ``block_motion_pyramid`` can represent:
    +-radius at the coarsest scale plus the residual refinements.
    levels=3, radius=4 -> 4*4 + 2*(2+1) = 22."""
    if levels <= 1:
        return radius
    return radius * (1 << (levels - 1)) + refine_radius * ((1 << (levels - 1)) - 1)


def _pad_edge_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge-replicate padding of the last two axes, any rank."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.clamp(torch.arange(-top, h + bottom, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-left, w + right, device=x.device), 0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _mean_blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    return blockwise_reduce(x, b, torch.mean)


def block_motion(
    prev: torch.Tensor,
    cur: torch.Tensor,
    block_size: int = 16,
    radius: int = 4,
    prev_weight: "torch.Tensor | None" = None,
    cur_weight: "torch.Tensor | None" = None,
    return_sad: bool = False,
):
    """Per-block integer motion from ``prev`` to ``cur``.

    prev/cur ``(N, H, W)`` luma -> mv ``(N, By, Bx, 2)`` int32 (dy, dx) such
    that content at cur position p came from prev position ``p - mv``.
    Candidate shifts are edge-clamped. ``prev_weight``/``cur_weight``
    (``(N,H,W)`` in [0,1], 1 = valid) make the SAD a masked match: invalid
    pixels are excluded, normalized by the valid mass, and offsets whose
    valid fraction is under 25% are penalized by 1e6. ``return_sad`` also
    returns the winning SAD per block.
    """
    # zero-motion-first candidate order: argmin keeps the FIRST minimum, so
    # ties resolve to the smallest motion
    offsets = sorted(
        ((dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)),
        key=lambda o: o[0] * o[0] + o[1] * o[1],
    )
    p = prev.float()
    c = cur.float()
    h, w = p.shape[-2], p.shape[-1]
    padded = _pad_edge_hw(p, radius, radius, radius, radius)
    weighted = prev_weight is not None or cur_weight is not None
    if weighted:
        wp = torch.ones_like(p) if prev_weight is None else prev_weight.float()
        wc = torch.ones_like(c) if cur_weight is None else cur_weight.float()
        # out-of-frame reads are invalid, not edge-extended
        padded_w = F.pad(wp, (radius, radius, radius, radius))
    sads = []
    for dy, dx in offsets:
        # shifted[y, x] = prev[clamp(y - dy), clamp(x - dx)]
        shifted = padded[..., radius - dy: radius - dy + h, radius - dx: radius - dx + w]
        if weighted:
            sw = padded_w[..., radius - dy: radius - dy + h, radius - dx: radius - dx + w]
            wgt = wc * sw
            num = _mean_blocks(torch.abs(c - shifted) * wgt, block_size)
            den = _mean_blocks(wgt, block_size)  # valid fraction
            sad = num / torch.clamp(den, min=1e-6) + torch.where(den < 0.25, 1e6, 0.0)
        else:
            sad = _mean_blocks(torch.abs(c - shifted), block_size)
        sads.append(sad)
    sads = torch.stack(sads, dim=-1)  # (N,By,Bx,K)
    best = torch.argmin(sads, dim=-1)
    table = torch.tensor(offsets, dtype=torch.int32, device=p.device)  # (K,2)
    if return_sad:
        # the winning masked SAD; >= 1e6 means no offset had enough valid mass
        return table[best], torch.amin(sads, dim=-1)
    return table[best]


def _warp_by_block_field(frames: torch.Tensor, mv: torch.Tensor, block_size: int) -> torch.Tensor:
    """``warped[p] = frames[p - mv[block(p)]]`` with edge clamping.

    frames ``(N,H,W)``, mv ``(N,By,Bx,2)`` integer pixels -> ``(N,H,W)``."""
    n, h, w = frames.shape
    dy = upsample_map(mv[..., 0].long(), block_size)
    dx = upsample_map(mv[..., 1].long(), block_size)
    yy = torch.arange(h, device=frames.device)[None, :, None]
    xx = torch.arange(w, device=frames.device)[None, None, :]
    sy = torch.clamp(yy - dy, 0, h - 1)
    sx = torch.clamp(xx - dx, 0, w - 1)
    base = torch.arange(n, device=frames.device)[:, None, None] * (h * w)
    return frames.reshape(-1)[base + sy * w + sx]


def field_sad(
    prev: torch.Tensor,
    cur: torch.Tensor,
    field: torch.Tensor,
    block_size: int,
    prev_weight: "torch.Tensor | None" = None,
    cur_weight: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Masked per-block SAD of warping ``prev`` by an integer block
    ``field`` (the convention of ``block_motion``). Out-of-frame reads and
    zero-weight pixels are excluded; a block with <25% valid mass is
    penalized to 1e6."""
    n, h, w = prev.shape
    f = torch.round(field).to(torch.int32)
    warped = _warp_by_block_field(prev.float(), f, block_size)
    wp = torch.ones(prev.shape, device=prev.device) if prev_weight is None else prev_weight.float()
    wc = torch.ones(cur.shape, device=cur.device) if cur_weight is None else cur_weight.float()
    wwarp = _warp_by_block_field(wp, f, block_size)
    dy = upsample_map(f[..., 0], block_size)
    dx = upsample_map(f[..., 1], block_size)
    yy = torch.arange(h, device=prev.device)[None, :, None]
    xx = torch.arange(w, device=prev.device)[None, None, :]
    inb = ((yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w)).float()
    wgt = wc * wwarp * inb
    num = _mean_blocks(torch.abs(cur.float() - warped) * wgt, block_size)
    den = _mean_blocks(wgt, block_size)
    return num / torch.clamp(den, min=1e-6) + torch.where(den < 0.25, 1e6, 0.0)


def median3_field(field: torch.Tensor) -> torch.Tensor:
    """3x3 spatial median of a block-motion field ``(N,By,Bx,2)`` (edge
    padded) -- the isolated-outlier killer for block matching."""
    f = field.float().movedim(-1, 1)  # (N,2,By,Bx)
    p = _pad_edge_hw(f, 1, 1, 1, 1)
    by, bx = f.shape[-2], f.shape[-1]
    stk = torch.stack([p[..., 1 + dy: 1 + dy + by, 1 + dx: 1 + dx + bx]
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=0)
    return torch.median(stk, dim=0).values.movedim(1, -1)  # nine values: the middle one


def _median(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median`` over ``dims``: the mean of the two middle values for
    an even count."""
    dims = sorted(d % x.dim() for d in dims)
    moved = x.movedim(dims, list(range(x.dim() - len(dims), x.dim())))
    flat = moved.reshape(*moved.shape[: x.dim() - len(dims)], -1)
    s = torch.sort(flat, dim=-1).values
    n = s.shape[-1]
    out = 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d)
    return out


def _nanmedian(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """``jnp.nanmedian`` over ``dims``: the median of the non-NaN values
    (mean of the two middle ones for an even count), NaN when there is none."""
    dims = sorted(d % x.dim() for d in dims)
    moved = x.movedim(dims, list(range(x.dim() - len(dims), x.dim())))
    flat = moved.reshape(*moved.shape[: x.dim() - len(dims)], -1)
    s = torch.sort(flat, dim=-1).values  # NaNs sort last
    k = (~torch.isnan(flat)).sum(dim=-1, keepdim=True)
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, max=s.shape[-1] - 1)
    out = 0.5 * (torch.gather(s, -1, lo) + torch.gather(s, -1, hi))
    out = torch.where(k > 0, out, float("nan"))[..., 0]
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d)
    return out


def subpel_refine(
    prev: torch.Tensor,
    cur: torch.Tensor,
    field: torch.Tensor,
    block_size: int,
    prev_weight: "torch.Tensor | None" = None,
    cur_weight: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Parabolic sub-pixel refinement of an integer block field: the masked
    SAD at the field and its four axis neighbours, a 1-D parabola per axis,
    ``field + delta`` (float, delta clipped to +-0.5)."""
    f = torch.round(field).to(torch.int32)
    sads = {}
    for key, (dy, dx) in (("c", (0, 0)), ("u", (-1, 0)), ("d", (1, 0)),
                          ("l", (0, -1)), ("r", (0, 1))):
        off = torch.tensor([dy, dx], dtype=torch.int32, device=f.device)
        sads[key] = field_sad(prev, cur, f + off, block_size, prev_weight, cur_weight)

    def para(sm, s0, sp):
        den = sm - 2.0 * s0 + sp
        d = torch.where(torch.abs(den) > 1e-6, 0.5 * (sm - sp) / den, 0.0)
        # only where the centre is the local minimum; an exact centre match
        # (SAD 0) is the minimum itself
        d = torch.where((s0 <= sm) & (s0 <= sp) & (s0 > 1e-3), d, 0.0)
        return torch.clamp(d, -0.5, 0.5)

    dy = para(sads["u"], sads["c"], sads["d"])
    dx = para(sads["l"], sads["c"], sads["r"])
    return f.float() + torch.stack([dy, dx], dim=-1)


def motion_hint(
    frames: torch.Tensor,
    block_size: int,
    radius: int = 4,
    levels: int = 4,
    coarse: int = 1,
    deadzone_px: float = 0.75,
    refine_radius: int = 2,
    est_scale: int = 2,
) -> tuple:
    """SERVER-side motion hint for the client inpaint fill, from the
    pristine frames.

    Returns ``(gmv (N-1,2) int16, dev (N-1,Cy,Cx,2) int8)`` in QUARTER-PEL
    units: per-pair global translation + coarse (``coarse`` estimation
    blocks per cell) local deviations, clipped to +-31.75 px. Estimated at
    ``est_scale`` x fill-block granularity, 3x3-median-filtered,
    parabolic-refined; deviations under ``deadzone_px`` are zeroed. Both
    arrays ship in the removal-mask sidecar.
    """
    from elvis_tpu_torch.ops.color import rgb_to_gray

    est_b = int(est_scale) * block_size
    luma = rgb_to_gray(frames.float()) if frames.dim() == 4 else frames.float()
    n, h, w = luma.shape
    hp = -(-h // est_b) * est_b
    wp = -(-w // est_b) * est_b
    if (hp, wp) != (h, w):
        luma = _pad_edge_hw(luma, 0, hp - h, 0, wp - w)
    mv, sad = block_motion_pyramid(
        luma[:-1], luma[1:], est_b, radius, levels=levels,
        refine_radius=refine_radius, return_sad=True)
    med_sad = _median(sad, (1, 2), keepdim=True)
    reliable = sad <= 3.0 * med_sad + 2.0
    l_int = torch.round(median3_field(mv)).to(torch.int32)
    l_sub = subpel_refine(luma[:-1], luma[1:], l_int, est_b)  # (N-1,ey,ex,2)
    masked = torch.where(reliable[..., None], l_sub, float("nan"))
    gmv_px = torch.nan_to_num(_nanmedian(masked, (1, 2)))  # (N-1,2) px
    gmv = torch.round(4.0 * gmv_px).to(torch.int16)  # quarter-pel
    dev = l_sub - (gmv.float() / 4.0)[:, None, None, :]
    if coarse > 1:
        ey, ex = dev.shape[1], dev.shape[2]
        cy, cx = -(-ey // coarse), -(-ex // coarse)
        dev = _pad_edge_hw(dev.movedim(-1, 1), 0, cy * coarse - ey, 0,
                           cx * coarse - ex).movedim(1, -1)
        dev = dev.reshape(n - 1, cy, coarse, cx, coarse, 2)
        dev = _median(dev, (2, 4))
    # dead zone: small deviations are estimator noise; zeroing them pins the
    # background to the global vector and keeps the field zlib-degenerate
    mag = torch.amax(torch.abs(dev), dim=-1, keepdim=True)
    dev = torch.where(mag < deadzone_px, 0.0, dev)
    return gmv, torch.clamp(torch.round(4.0 * dev), -127, 127).to(torch.int8)


def motion_field_from_hint(
    gmv: torch.Tensor,
    dev: torch.Tensor,
    by: int,
    bx: int,
    coarse: int = 1,
    est_scale: int = 2,
) -> torch.Tensor:
    """CLIENT side: expand a ``motion_hint`` to the fill grid -- per-pair
    block motion ``(N, By, Bx, 2)`` float32 PIXELS (frame 0 zeros; the
    transported ints are quarter-pel)."""
    f = (dev.float() + gmv[:, None, None, :].float()) / 4.0  # (m,Cy,Cx,2) px
    if coarse > 1:
        f = f.repeat_interleave(coarse, dim=1).repeat_interleave(coarse, dim=2)
    s = int(est_scale)
    f = f.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)[:, :by, :bx]
    return torch.cat([torch.zeros((1, by, bx, 2), dtype=torch.float32, device=f.device), f])


def block_motion_pyramid(
    prev: torch.Tensor,
    cur: torch.Tensor,
    block_size: int = 16,
    radius: int = 4,
    levels: int = 3,
    refine_radius: int = 2,
    prev_weight: "torch.Tensor | None" = None,
    cur_weight: "torch.Tensor | None" = None,
    return_sad: bool = False,
):
    """Coarse-to-fine block motion: the convention of ``block_motion`` with
    range ``radius * 2^(levels-1) + ...``. The coarsest level searches
    +-radius at 1/2^(levels-1) resolution; each finer level warps ``prev``
    by the upsampled prior field and searches +-refine_radius. Weights
    downsample by area mean and warp with their frames. Coarser levels pad
    to alignment internally (edge-mode frames, zero-weight validity); the
    field comes back on the original ``(N, H/b, W/b, 2)`` grid."""
    if levels <= 1:
        return block_motion(prev, cur, block_size, radius,
                            prev_weight, cur_weight, return_sad=return_sad)
    p = prev.float()
    c = cur.float()
    n, h, w = p.shape
    weighted = prev_weight is not None or cur_weight is not None
    if weighted:
        wp_full = torch.ones_like(p) if prev_weight is None else prev_weight.float()
        wc_full = torch.ones_like(c) if cur_weight is None else cur_weight.float()
    s_max = 1 << (levels - 1)
    align = block_size * s_max
    hp, wp = -(-h // align) * align, -(-w // align) * align
    if (hp, wp) != (h, w):
        p = _pad_edge_hw(p, 0, hp - h, 0, wp - w)
        c = _pad_edge_hw(c, 0, hp - h, 0, wp - w)
        if weighted:
            # alignment padding is fake content: zero validity
            wp_full = F.pad(wp_full, (0, wp - w, 0, hp - h))
            wc_full = F.pad(wc_full, (0, wp - w, 0, hp - h))

    def down(x, s):
        if s == 1:
            return x
        return x.reshape(n, hp // s, s, wp // s, s).mean(dim=(2, 4))

    def down_masked(x, wgt, s):
        """Weighted-mean downsample: hole pixels pass their weight, not
        their zeroed values, to the coarse image."""
        if s == 1:
            return x
        return down(x * wgt, s) / torch.clamp(down(wgt, s), min=1e-6)

    mv, sad = None, None
    for k in range(levels - 1, -1, -1):
        s = 1 << k
        final = k == 0 and return_sad
        if weighted:
            pk = down_masked(p, wp_full, s)
            ck = down_masked(c, wc_full, s)
            wpk, wck = down(wp_full, s), down(wc_full, s)
        else:
            pk, ck = down(p, s), down(c, s)
            wpk = wck = None
        if mv is None:
            res = block_motion(pk, ck, block_size, radius, wpk, wck, return_sad=final)
            mv, sad = res if final else (res, None)
        else:
            # upsample the prior field: 2x denser grid, 2x pixel values
            mv = (mv * 2).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            warped = _warp_by_block_field(pk, mv, block_size)
            if weighted:
                wpk = _warp_by_block_field(wpk, mv, block_size)
            res = block_motion(warped, ck, block_size, refine_radius, wpk, wck,
                               return_sad=final)
            dmv, sad = res if final else (res, None)
            mv = mv + dmv
    mv = mv[:, : h // block_size, : w // block_size]
    if return_sad:
        return mv, sad[:, : h // block_size, : w // block_size]
    return mv
