"""Inpainting restorers for the removal degradation (port of
``elvis_tpu.restore.inpaint``).

``diffusion`` is PDE (heat-equation) inpainting: masked Jacobi relaxation
that propagates boundary colours inward -- the niche of OpenCV's Telea fill,
a smooth fill from the hole boundary. Each of the 200 iterations replaces
every hole pixel by the mean of its four neighbours (edge rows and columns
replicated), known pixels pinned.

``temporal`` is motion-compensated temporal propagation, the counterpart of
ProPainter's flow-guided fill with block matching in place of optical flow:
each removed block is filled from the temporally nearest frame (within
+-``window``, then every ``ref_stride``-th frame of the clip) where the
content it should hold survives, reached along displacements composed over
the block-motion trajectory; the warped fill is blended per hole with the
PDE fill by how well the same warp predicts the hole's surviving ring, and
holes with no clean source keep the PDE fill. The motion is the
server's transmitted hint when there is one, else estimated here on the
holed frames.

Medians over an even count average the two middle values, as ``jnp.median``
does (``ops.motion._median`` / ``_nanmedian``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from elvis_tpu_torch.core.blocks import blockwise_reduce, upsample_map
from elvis_tpu_torch.ops.color import rgb_to_gray
from elvis_tpu_torch.ops.motion import (
    _median,
    _nanmedian,
    _pad_edge_hw,
    block_motion_pyramid,
    field_sad,
    median3_field,
)
from elvis_tpu_torch.restore.registry import register_restorer

__all__ = ["restore_removal_diffusion", "restore_removal_temporal"]

# the temporal fill's fixed settings, as the reference's defaults: Jacobi
# iterations of its PDE fill and ring probe, pyramid levels of the hole
# motion estimate, and the least weight the warped fill keeps in the blend
_TEMPORAL_ITERS = 60
_MOTION_LEVELS = 3
_BLEND_FLOOR = 0.25


def _masked_jacobi(frames: torch.Tensor, hole: torch.Tensor, iters: int) -> torch.Tensor:
    """Relax hole pixels toward the 4-neighbour mean; known pixels pinned.

    frames float32 ``(N,H,W,C)``, hole bool ``(N,H,W,1)``."""
    known = torch.where(hole, 0.0, frames)
    # start from the mean of the known pixels for faster convergence
    denom = torch.clamp((~hole).sum(dim=(1, 2), keepdim=True), min=1)
    mean = known.sum(dim=(1, 2), keepdim=True) / denom
    x = torch.where(hole, mean, known).permute(0, 3, 1, 2)  # (N,C,H,W)
    hole_c = hole.permute(0, 3, 1, 2)
    known_c = known.permute(0, 3, 1, 2)
    h, w = x.shape[-2], x.shape[-1]
    for _ in range(iters):
        p = F.pad(x, (1, 1, 1, 1), mode="replicate")
        # (up + down + left + right) * 0.25, in the reference's order
        avg = (p[..., 0:h, 1:w + 1] + p[..., 2:h + 2, 1:w + 1] + p[..., 1:h + 1, 0:w]
               + p[..., 1:h + 1, 2:w + 2]) * 0.25
        x = torch.where(hole_c, avg, known_c)
    return x.permute(0, 2, 3, 1)


@register_restorer("removal", "diffusion")
def restore_removal_diffusion(
    frames: torch.Tensor,
    removal_mask: torch.Tensor,
    block_size: int,
    iters: int = 200,
) -> torch.Tensor:
    """frames ``(N,H,W,C)`` stretched (holes black), removal_mask
    ``(N,By,Bx)`` nonzero = removed. Integer frames come back rounded and
    clipped in their own type."""
    hole = upsample_map(removal_mask.bool(), block_size)[..., None]
    out = _masked_jacobi(frames.float(), hole, iters)
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)


@register_restorer("removal", "temporal")
def restore_removal_temporal(
    frames: torch.Tensor,
    removal_mask: torch.Tensor,
    block_size: int,
    window: int = 8,
    motion_radius: int = 4,
    ref_stride: int = 0,
    max_refs: int = -1,
    motion_field: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Fill each removed block from the temporally nearest frame (within
    +-``window``) where its content survives, warped along the composed
    block motion, then blend with the PDE fill (60 Jacobi iterations).

    frames ``(N,H,W,C)`` stretched (holes black), removal_mask
    ``(N,By,Bx)`` nonzero = removed. ``motion_field`` ``(N,By,Bx,2)``
    float pixels (the expanded server hint: content at ``(t, p)`` came from
    ``(t-1, p - mv[t])``) replaces the estimate; ``motion_radius=0`` fills
    co-located (zero motion). Blocks with no clean source in the window try
    every ``ref_stride``-th frame (0 = none, at most ``max_refs`` of them,
    -1 = all), then keep the PDE fill. Integer frames come back rounded and
    clipped in their own type."""
    n = frames.shape[0]
    removed = removal_mask.bool()
    if motion_field is not None and motion_radius > 0 and n > 1:
        mv = motion_field.float()
    elif motion_radius > 0 and n > 1:
        mv = _estimate_hole_motion(frames, removed, block_size, motion_radius).float()
    else:
        mv = torch.zeros(removed.shape + (2,), dtype=torch.float32, device=frames.device)
    out = _propagate_fill(frames, removed, mv, block_size, window, ref_stride, max_refs)
    if not frames.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(frames.dtype)


def _estimate_hole_motion(frames: torch.Tensor, removed: torch.Tensor, block_size: int,
                          motion_radius: int) -> torch.Tensor:
    """Per-pair block motion ``(N,By,Bx,2)`` int32 of a holed clip (frame 0
    zeros): a per-pair global translation (the median over reliable clean
    blocks), and the 3x3-median local field only where its masked warp SAD
    beats the global one by a margin. Estimated at twice the fill block
    size, hole pixels masked out of the SAD."""
    n = frames.shape[0]
    by, bx = removed.shape[1], removed.shape[2]
    est_b = 2 * block_size
    luma = rgb_to_gray(frames.float())
    valid = 1.0 - upsample_map(removed, block_size).float()
    h, w = luma.shape[1], luma.shape[2]
    hp = -(-h // est_b) * est_b
    wp = -(-w // est_b) * est_b
    if (hp, wp) != (h, w):  # edge luma, zero validity
        luma = _pad_edge_hw(luma, 0, hp - h, 0, wp - w)
        valid = F.pad(valid, (0, wp - w, 0, hp - h))
    mv, sad = block_motion_pyramid(luma[:-1], luma[1:], est_b, motion_radius,
                                   levels=_MOTION_LEVELS, prev_weight=valid[:-1],
                                   cur_weight=valid[1:], return_sad=True)
    ey, ex = mv.shape[1], mv.shape[2]
    # clean at the estimation grid: every covered fill block clean in both frames
    pc = ~removed[:-1] & ~removed[1:]
    pc = F.pad(pc, (0, 2 * ex - bx, 0, 2 * ey - by), value=False)
    clean_e = pc.reshape(n - 1, ey, 2, ex, 2).all(dim=4).all(dim=2)
    sad_clean = torch.where(clean_e, sad, float("nan"))
    med_sad = torch.nan_to_num(_nanmedian(sad_clean, (1, 2), keepdim=True))
    reliable = clean_e & (sad <= 3.0 * med_sad + 2.0)

    masked = torch.where(reliable[..., None], mv.float(), float("nan"))
    gmed = torch.round(torch.nan_to_num(_nanmedian(masked, (1, 2), keepdim=True))).to(torch.int32)
    g_field = gmed.expand(mv.shape)
    l_field = torch.round(median3_field(mv)).to(torch.int32)
    sad_g = field_sad(luma[:-1], luma[1:], g_field, est_b, valid[:-1], valid[1:])
    sad_l = field_sad(luma[:-1], luma[1:], l_field, est_b, valid[:-1], valid[1:])
    # the local field only where it is clearly better: codec noise makes
    # small SAD differences meaningless; unmatchable blocks stay global
    take_local = sad_l + 2.0 + 0.25 * sad_g < sad_g
    mv = torch.where(take_local[..., None], l_field, g_field)
    mv = mv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :by, :bx]
    return torch.cat([torch.zeros((1, by, bx, 2), dtype=torch.int32, device=mv.device), mv])


def _compose_displacements(mv: torch.Tensor, window: int, block_size: int):
    """Displacement chains composed along trajectories from per-pair block
    motion ``mv`` ``(N,By,Bx,2)`` (``mv[t]``: content at ``(t, p)`` came from
    ``(t-1, p - mv[t](p))``, pixels). Returns ``(back, fwd)``, ``window``
    fields each: ``back[d-1][t](p)`` is the displacement to frame ``t-d``
    (the content sits at ``(t-d, p - back)``), ``fwd[d-1]`` the same toward
    ``t+d``. Each step samples the next pair's field at the moved position
    (bilinear on the block grid, edge-clamped); the forward fields start
    from the scatter inverse of ``mv[t+1]``."""
    n, by, bx = mv.shape[0], mv.shape[1], mv.shape[2]
    bs = float(block_size)
    dev = mv.device
    yy = torch.arange(by, device=dev)[None, :, None]
    xx = torch.arange(bx, device=dev)[None, None, :]
    ni = torch.arange(n, device=dev)[:, None, None]

    def sample(field, off_px):
        """field sampled at ``p - off_px / bs`` (both (N,By,Bx,2))."""
        sy = yy - off_px[..., 0] / bs
        sx = xx - off_px[..., 1] / bs
        iy = torch.floor(sy)
        ix = torch.floor(sx)
        fy = (sy - iy)[..., None]
        fx = (sx - ix)[..., None]
        y0 = torch.clamp(iy.long(), 0, by - 1)
        x0 = torch.clamp(ix.long(), 0, bx - 1)
        y1 = torch.clamp(y0 + 1, 0, by - 1)
        x1 = torch.clamp(x0 + 1, 0, bx - 1)
        v00 = field[ni, y0, x0]
        v01 = field[ni, y0, x1]
        v10 = field[ni, y1, x0]
        v11 = field[ni, y1, x1]
        top = v00 + fx * (v01 - v00)
        bot = v10 + fx * (v11 - v10)
        return top + fy * (bot - top)

    def shift_back(x):  # x[t] <- x[t-1]
        return torch.cat([x[:1], x[:-1]])

    def shift_fwd(x):  # x[t] <- x[t+1]
        return torch.cat([x[1:], x[-1:]])

    def invert(mvn):
        """Forward field by scatter: each correspondence's motion goes to
        its source block, weighted by its deviation from the frame's median
        motion (a mover outweighs the disoccluded background); blocks
        nothing maps to take the median (the pan)."""
        gmed = _median(mvn, (1, 2), keepdim=True)
        ty = yy - mvn[..., 0] / bs
        tx = xx - mvn[..., 1] / bs
        sy = torch.clamp(torch.round(ty), 0, by - 1)
        sx = torch.clamp(torch.round(tx), 0, bx - 1)
        inb = (ty >= -0.5) & (ty <= by - 0.5) & (tx >= -0.5) & (tx <= bx - 0.5)
        nb = by * bx
        flat = (ni * nb + sy.long() * bx + sx.long()).reshape(-1)
        dev_mag = torch.abs(mvn - gmed).sum(-1)
        wgt = (inb.float() * (1e-3 + 100.0 * dev_mag)).reshape(-1, 1)
        # float atomics on the card: the sums' order is not fixed there
        num = torch.zeros((n * nb, 2), dtype=torch.float32, device=dev).index_add_(
            0, flat, mvn.reshape(-1, 2) * wgt)
        den = torch.zeros((n * nb, 1), dtype=torch.float32, device=dev).index_add_(0, flat, wgt)
        f = (num / torch.clamp(den, min=1e-9)).reshape(mvn.shape)
        return torch.where(den.reshape(*mvn.shape[:-1], 1) > 1e-4, f, gmed.expand(mvn.shape))

    g1 = invert(shift_fwd(mv))
    back, fwd = [mv], [g1]
    for _ in range(1, window):
        back.append(back[0] + sample(shift_back(back[-1]), back[0]))
        fwd.append(fwd[0] + sample(shift_fwd(fwd[-1]), -fwd[0]))
    # forward convention: the content sits at (t+d, p + fwd) == (s, p - (-fwd))
    return back, [-f for f in fwd]


def _shift_blocks(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``x[:, y + dy, x + dx]`` of a block map ``(N,By,Bx)``, ``fill`` past
    the edge (no wraparound)."""
    by, bx = x.shape[1], x.shape[2]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[:, 1 + dy: 1 + dy + by, 1 + dx: 1 + dx + bx]


def _propagate_fill(frames: torch.Tensor, removed: torch.Tensor, mv: torch.Tensor,
                    block_size: int, window: int, ref_stride: int = 0,
                    max_refs: int = -1) -> torch.Tensor:
    """One propagation pass: the nearest clean (warped) source per removed
    block, a bilinear pixel gather along its displacement, and a per-hole
    blend with the PDE fill. ``mv`` is the per-pair block motion (float
    pixels; zeros = co-located). Returns float32 frames."""
    n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    by, bx = removed.shape[1], removed.shape[2]
    bs = block_size
    dev = frames.device
    t_idx = torch.arange(n, device=dev)
    grid_by = torch.arange(by, device=dev)[:, None]
    grid_bx = torch.arange(bx, device=dev)[None, :]

    mv = mv.float()
    back_d, fwd_d = _compose_displacements(mv, window, block_size)
    # non-local references sit at any distance: compose the per-frame
    # median motion (the pan), not the block field
    cum_g = torch.cumsum(_median(mv, (1, 2), keepdim=True), dim=0)  # (N,1,1,2)
    best_src = torch.full(removed.shape, -1, dtype=torch.long, device=dev)
    best_dy = torch.zeros(removed.shape, dtype=torch.float32, device=dev)
    best_dx = torch.zeros(removed.shape, dtype=torch.float32, device=dev)

    def consider(state, s_idx, disp, valid=None):
        """Fold candidate source frames ``s_idx`` (N,) at displacement
        ``disp`` (N,By,Bx,2) into the first-clean-wins state. Every source
        block the warped read touches (one more pixel per fractional axis,
        for the bilinear tap) must be clean and in frame."""
        best_src, best_dy, best_dx = state
        y0 = grid_by * bs - disp[..., 0]
        x0 = grid_bx * bs - disp[..., 1]
        iy0 = torch.floor(y0).long()
        ix0 = torch.floor(x0).long()
        span_y = bs - 1 + (y0 > iy0).long()
        span_x = bs - 1 + (x0 > ix0).long()
        qy_lo = torch.div(iy0, bs, rounding_mode="floor")
        qy_hi = torch.div(iy0 + span_y, bs, rounding_mode="floor")
        qx_lo = torch.div(ix0, bs, rounding_mode="floor")
        qx_hi = torch.div(ix0 + span_x, bs, rounding_mode="floor")
        inb = (iy0 >= 0) & (iy0 + span_y <= h - 1) & (ix0 >= 0) & (ix0 + span_x <= w - 1)
        sn = s_idx[:, None, None]

        def ok(qy, qx):
            return ~removed[sn, torch.clamp(qy, 0, by - 1), torch.clamp(qx, 0, bx - 1)]

        clean = inb & ok(qy_lo, qx_lo) & ok(qy_lo, qx_hi) & ok(qy_hi, qx_lo) & ok(qy_hi, qx_hi)
        take = (best_src < 0) & clean & (s_idx != t_idx)[:, None, None]
        if valid is not None:
            take = take & valid[:, None, None]
        return (torch.where(take, sn, best_src), torch.where(take, disp[..., 0], best_dy),
                torch.where(take, disp[..., 1], best_dx))

    state = (best_src, best_dy, best_dx)
    for d in range(1, window + 1):
        state = consider(state, torch.clamp(t_idx - d, 0, n - 1), back_d[d - 1], t_idx - d >= 0)
        state = consider(state, torch.clamp(t_idx + d, 0, n - 1), fwd_d[d - 1],
                         t_idx + d <= n - 1)
    if ref_stride and ref_stride > 0:
        # non-local references only where the window found no clean source
        refs = list(range(0, n, int(ref_stride)))
        if max_refs and max_refs > 0:
            refs = refs[: int(max_refs)]
        for r_ in refs:
            state = consider(state, torch.full((n,), r_, dtype=torch.long, device=dev),
                             (cum_g - cum_g[r_]).expand(mv.shape))
    best_src, best_dy, best_dx = state
    never_avail = best_src < 0
    src = torch.where(never_avail, t_idx[:, None, None], best_src)
    hole_blocks = removed & ~never_avail

    # context ring: each surviving block next to a sourced hole inherits the
    # hole's (src, disp), so the same warp is scored on pixels that exist
    ext_src, ext_dy, ext_dx = src, best_dy, best_dx
    have = hole_blocks
    for dy_ in (-1, 0, 1):
        for dx_ in (-1, 0, 1):
            if dy_ == 0 and dx_ == 0:
                continue
            takeq = ~have & _shift_blocks(hole_blocks, dy_, dx_, False) & ~removed
            ext_src = torch.where(takeq, _shift_blocks(src, dy_, dx_, 0), ext_src)
            ext_dy = torch.where(takeq, _shift_blocks(best_dy, dy_, dx_, 0.0), ext_dy)
            ext_dx = torch.where(takeq, _shift_blocks(best_dx, dy_, dx_, 0.0), ext_dx)
            have = have | takeq
    ring = have & ~hole_blocks

    # warped gather at pixel resolution, bilinear for fractional
    # displacements (integer ones reduce to the exact single tap); the four
    # flat corner indices are built once and serve both gathers
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    sy_f = yy - upsample_map(ext_dy, bs)
    sx_f = xx - upsample_map(ext_dx, bs)
    iy = torch.floor(sy_f)
    ix = torch.floor(sx_f)
    fy = (sy_f - iy)[..., None]
    fx = (sx_f - ix)[..., None]
    del sy_f, sx_f
    sy = torch.clamp(iy.long(), 0, h - 1)
    sx = torch.clamp(ix.long(), 0, w - 1)
    del iy, ix
    row0 = upsample_map(ext_src, bs) * (h * w) + sy * w
    row1 = row0 + (torch.clamp(sy + 1, 0, h - 1) - sy) * w
    dx1 = torch.clamp(sx + 1, 0, w - 1) - sx
    corners = (row0 + sx, row0 + sx + dx1, row1 + sx, row1 + sx + dx1)
    del row0, row1, sy, sx, dx1
    ff = frames.float()

    def bilerp(img):
        flat = img.reshape(n * h * w, img.shape[-1])
        v00, v01, v10, v11 = (flat[c] for c in corners)
        top = v00 + fx * (v01 - v00)
        bot = v10 + fx * (v11 - v10)
        return top + fy * (bot - top)

    filled = bilerp(ff)

    # per-hole blend weight alpha = s_pde^2 / (s_pde^2 + s_warp^2): s_warp
    # is the ring's mean error under the same warp, s_pde the ring's error
    # under a Jacobi pass over holes and ring together
    valid = 1.0 - upsample_map(removed, bs).float()
    # the ring's warp has no cleanliness guarantee at the source: weight by
    # the source's validity read through the same warp
    wgt = valid * bilerp(valid[..., None])[..., 0]
    del corners, fx, fy
    den_w = blockwise_reduce(wgt, bs, torch.mean)
    num_b = blockwise_reduce(torch.abs(filled - ff).mean(-1) * wgt, bs, torch.mean)
    del wgt
    ring_sad = torch.where(ring & (den_w > 0.25), num_b / torch.clamp(den_w, min=1e-6),
                           float("nan"))

    all_hole_pix = upsample_map(removed, bs)[..., None]
    pdefill = _masked_jacobi(ff, all_hole_pix, _TEMPORAL_ITERS)
    ring_pix = upsample_map(ring, bs)[..., None]
    pde_probe = _masked_jacobi(ff, all_hole_pix | ring_pix, _TEMPORAL_ITERS)
    ring_f = ring_pix[..., 0].float()
    pde_err_pix = torch.abs(pde_probe - ff).mean(-1) * ring_f
    del pde_probe
    den_r = blockwise_reduce(ring_f, bs, torch.mean)
    tex_b = torch.where(ring, blockwise_reduce(pde_err_pix, bs, torch.mean)
                        / torch.clamp(den_r, min=1e-6), float("nan"))

    def pool9(x):
        stk = torch.stack([_shift_blocks(x, dy_, dx_, float("nan"))
                           for dy_ in (-1, 0, 1) for dx_ in (-1, 0, 1)])
        return torch.nanmean(stk, dim=0)

    def frame_fallback(x):
        """Per-frame median of a block signal, the clip's where a frame has
        none, 0 where the clip has none."""
        f_ = _nanmedian(x, (1, 2), keepdim=True)
        return torch.nan_to_num(torch.where(torch.isnan(f_), _nanmedian(x, (0, 1, 2)), f_),
                                nan=0.0)

    ctx = pool9(ring_sad)  # warp-error scale per hole block
    tau = pool9(tex_b)     # diffusion-error scale per hole block
    # holes whose ring carries no signal take the frame's typical value (0 on
    # a static clip, which keeps the static recovery exact)
    ctx = torch.where(torch.isnan(ctx), frame_fallback(ring_sad), ctx)
    tau = torch.where(torch.isnan(tau), frame_fallback(tex_b), tau)
    sp2 = tau ** 2
    alpha = torch.clamp(torch.nan_to_num(sp2 / torch.clamp(sp2 + ctx ** 2, min=1e-6), nan=0.0),
                        _BLEND_FLOOR, 1.0)
    # an exact ring match trusts the warp outright, flat blocks included
    alpha = torch.where(ctx <= 0.0, 1.0, alpha)
    alpha = torch.where(hole_blocks, alpha, 0.0)
    a_pix = upsample_map(alpha, bs)[..., None]
    return torch.where(all_hole_pix, a_pix * filled + (1.0 - a_pix) * pdefill, ff)
