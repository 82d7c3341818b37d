"""The one general generator of the benchmark's inputs, driven by a traffic
file's parameters and the run's seed.

Content: colour video under a slow pan of a textured background, with
textured objects moving across it and N(0, sigma) noise, so that a codec's
motion search and residuals do real work. Level maps: a smooth random
field per segment, quantised to ``0..max_level`` with ``max_level`` present
in every segment. Degraded frames: each block area-averaged by its factor
``2**level`` and repeated back (the benchmark's own plain resample).

Every seed gives the same sizes, speeds, texture periods and amplitudes
(fixed lists in the traffic file). Everything is drawn on ``device`` from
one ``torch.Generator`` seeded with the run's seed, unless the mix names a
``scene_seed`` (in ``content`` or ``levels``): then the scenes (colours,
textures, positions, directions) or the level fields come from that fixed
seed, and the run's seed draws the noise and the order of the pool. A codec's
work follows the scene, so such a mix asks the same work of every seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def _scene_generator(params: dict, gen: torch.Generator, device) -> torch.Generator:
    """The mix's fixed ``scene_seed`` generator where it names one, else ``gen``."""
    seed = params.get("scene_seed")
    return gen if seed is None else generator(seed, device)


def _in_run_order(pool: torch.Tensor, sgen: torch.Generator, gen: torch.Generator) -> torch.Tensor:
    """``pool`` as drawn where it came from the run's generator, else in an
    order drawn from it."""
    if sgen is gen:
        return pool
    return pool[torch.randperm(pool.shape[0], generator=gen, device=gen.device).to(pool.device)]


def _rand(gen, *shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _uniform(gen, lo, hi, device, *shape):
    return lo + (hi - lo) * _rand(gen, *shape, device=device)


def _grating(gen, yy, xx, params, device):
    """A colour texture ``(H, W, 3)`` around 0: one oriented sine grating per
    entry of ``texture_periods`` (with the amplitude of the same place in
    ``texture_amplitudes``), each in a colour of its own."""
    out = 0.0
    for period, amp in zip(params["texture_periods"], params["texture_amplitudes"]):
        theta = _uniform(gen, 0.0, math.pi, device, 1)
        phase = _uniform(gen, 0.0, 2 * math.pi, device, 1)
        colour = _uniform(gen, -1.0, 1.0, device, 3)
        wave = torch.sin(2 * math.pi * (xx * torch.cos(theta) + yy * torch.sin(theta)) / period
                         + phase)
        out = out + amp * wave[..., None] * colour
    return out


def make_segments(params: dict, n_segments: int, frames: int, height: int, width: int,
                  gen: torch.Generator, device) -> torch.Tensor:
    """uint8 ``(S, N, H, W, 3)``: ``n_segments`` distinct segments."""
    sgen = _scene_generator(params, gen, device)
    pan = float(params["pan_px_per_frame"])
    margin = int(math.ceil(pan * frames)) + 1
    ch, cw = height + 2 * margin, width + 2 * margin
    cy = torch.arange(ch, device=device, dtype=torch.float32)[:, None]
    cx = torch.arange(cw, device=device, dtype=torch.float32)[None, :]
    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    lo_h, lo_w = max(1, ch // 96), max(1, cw // 96)
    out = torch.empty((n_segments, frames, height, width, 3), dtype=torch.uint8, device=device)
    for s in range(n_segments):
        base = _uniform(sgen, 70.0, 180.0, device, 3)
        blobs = F.interpolate((_rand(sgen, 1, 3, lo_h, lo_w, device=device) - 0.5) * 80.0,
                              size=(ch, cw), mode="bilinear", align_corners=False)
        canvas = base + blobs[0].permute(1, 2, 0) + _grating(sgen, cy, cx, params, device)
        angle = _uniform(sgen, 0.0, 2 * math.pi, device, 1).item()
        vy, vx = pan * math.sin(angle), pan * math.cos(angle)
        objs = []
        for ry, rx in params["object_radii"]:
            oy = _uniform(sgen, 0.0, height, device, 1).item()
            ox = _uniform(sgen, 0.0, width, device, 1).item()
            a = _uniform(sgen, 0.0, 2 * math.pi, device, 1).item()
            speed = float(params["object_speed_px"])
            colour = _uniform(sgen, 20.0, 235.0, device, 3)
            tex = _grating(sgen, yy, xx, params, device)
            objs.append((ry, rx, oy, ox, speed * math.sin(a), speed * math.cos(a), colour, tex))
        for t in range(frames):
            y0, x0 = margin + int(round(vy * t)), margin + int(round(vx * t))
            frame = canvas[y0:y0 + height, x0:x0 + width]
            for ry, rx, oy, ox, dy, dx, colour, tex in objs:
                inside = ((yy - (oy + dy * t)) / ry) ** 2 + ((xx - (ox + dx * t)) / rx) ** 2 <= 1.0
                shifted = torch.roll(tex, (int(round(dy * t)), int(round(dx * t))), (0, 1))
                frame = torch.where(inside[..., None], colour + shifted, frame)
            noise = torch.randn((height, width, 3), generator=gen, device=device)
            frame = frame + float(params["noise_sigma"]) * noise
            out[s, t] = torch.clamp(torch.round(frame), 0, 255).to(torch.uint8)
    return _in_run_order(out, sgen, gen)


def make_levels(params: dict, n_segments: int, frames: int, by: int, bx: int,
                gen: torch.Generator, device) -> torch.Tensor:
    """int32 ``(S, N, By, Bx)`` in ``0..max_level``, a smooth random field
    per segment, normalised so that every segment holds ``max_level``."""
    sgen = _scene_generator(params, gen, device)
    max_level = int(params["max_level"])
    cells = int(params["field_cells"])
    field = torch.randn((n_segments * frames, 1, cells, max(1, cells * bx // by)),
                        generator=sgen, device=device)
    field = F.interpolate(field, size=(by, bx), mode="bilinear", align_corners=False)
    field = field.reshape(n_segments, frames, by, bx)
    field = torch.cat([field[:, :1], 0.5 * (field[:, 1:] + field[:, :-1])], dim=1)
    lo = field.amin(dim=(1, 2, 3), keepdim=True)
    hi = field.amax(dim=(1, 2, 3), keepdim=True)
    unit = (field - lo) / (hi - lo)
    levels = torch.clamp(torch.floor(unit * (max_level + 1)), 0, max_level).to(torch.int32)
    return _in_run_order(levels, sgen, gen)


def degrade(frames: torch.Tensor, levels: torch.Tensor, block: int) -> torch.Tensor:
    """uint8 ``(N, H, W, 3)`` and int ``(N, By, Bx)`` levels -> uint8: each
    block averaged over cells of ``2**level`` pixels and repeated back."""
    n, h, w, c = frames.shape
    x = frames.float()
    out = x.clone()
    pix = levels.repeat_interleave(block, 1).repeat_interleave(block, 2)[..., None]
    for lvl in range(1, int(math.log2(block)) + 1):
        f = 2**lvl
        small = x.reshape(n, h // f, f, w // f, f, c).mean(dim=(2, 4))
        up = small.repeat_interleave(f, 1).repeat_interleave(f, 2)
        out = torch.where(pix == lvl, up, out)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
