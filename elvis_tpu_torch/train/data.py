"""Training data: procedural clips, augmentations and degradations (port of
``elvis_tpu.train.data``).

Training pairs are made on the device from a seed: structured procedural
content (waves, rectangles, disks, dead leaves with fractal texture,
text- and architecture-like lattices) degraded by the port's own
degradation ops, the distribution the restorers see at inference.

Random draws come from an explicit ``torch.Generator`` (the first argument,
in place of the JAX package's key); tensors are made on the generator's
device. The values are not ``jax.random``'s (an intended divergence): the
same formulas on other draws. Where the JAX function draws two values from
one key with the same shape and distribution they are equal, and the port
keeps that (the rectangle's amplitude and its centre row; the illumination
gradient's two axes). ``codec_noise_at`` is ``codec_noise``'s arithmetic
for given draws.

``photo_patch_pool`` opens photographs shipped inside installed packages
(scikit-learn, matplotlib, dm_control, gymnasium_robotics) through PIL;
where one is missing it raises ``ImportError`` naming it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "synthetic_frames",
    "synthetic_sr_batch",
    "synthetic_video_batch",
    "dead_leaves",
    "fractal_noise",
    "natural_frames",
    "natural_video_batch",
    "structured_frames",
    "codec_noise",
    "codec_noise_at",
    "photo_patch_pool",
    "photo_video_batch",
    "photometric_augment",
    "sensor_augment",
]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _randint(gen: torch.Generator, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def photometric_augment(gen: torch.Generator, frames: torch.Tensor) -> torch.Tensor:
    """Per-sample photometric jitter on CLEAN sources (before degradation,
    so the pair stays consistent): gamma, gain, a per-channel colour cast
    and a brightness offset."""
    b = frames.shape[0]
    x = frames.float() / 255.0
    gamma = torch.exp(_uniform(gen, (b, 1, 1, 1), -0.35, 0.35))
    gain = _uniform(gen, (b, 1, 1, 1), 0.8, 1.2)
    cast = _uniform(gen, (b, 1, 1, 3), 0.92, 1.08)
    offset = _uniform(gen, (b, 1, 1, 1), -0.06, 0.06)
    x = torch.clamp(x, 1e-6, 1.0) ** gamma
    x = x * gain * cast + offset
    return torch.clamp(x * 255.0, 0.0, 255.0)


def sensor_augment(gen: torch.Generator, frames: torch.Tensor,
                   fraction: float = 0.4) -> torch.Tensor:
    """Camera-sensor grain on CLEAN sources, kept by the ground truth: film
    grain weighted to the shadows, extra chroma noise on ~40% of samples'
    channels, applied to ``fraction`` of the samples."""
    b = frames.shape[0]
    x = frames.float()
    sigma = _uniform(gen, (b, 1, 1, 1), 0.5, 5.0)
    chroma = _bernoulli(gen, 0.4, (b, 1, 1, 3))
    cscale = torch.where(chroma, _uniform(gen, (b, 1, 1, 3), 1.0, 2.0), 1.0)
    shadow = 1.0 + 0.8 * (1.0 - x / 255.0)  # 1.0 (highlights) .. 1.8 (shadows)
    noisy = x + sigma * cscale * shadow * _normal(gen, x.shape)
    apply = _bernoulli(gen, fraction, (b, 1, 1, 1))
    return torch.where(apply, torch.clamp(noisy, 0.0, 255.0), frames.float())


def synthetic_frames(gen: torch.Generator, batch: int, height: int, width: int) -> torch.Tensor:
    """Procedural content mixing oriented waves, a hard-edged rectangle, a
    smooth disk, multi-frequency texture and noise: ``(B,H,W,3)`` float32
    in [0, 255]."""
    dev = gen.device
    yy = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :, None]
    shape1 = (batch, 1, 1, 1)

    freq = _uniform(gen, (batch, 1, 1, 3), 0.02, 0.5)
    phase = _uniform(gen, (batch, 1, 1, 3), 0.0, 6.28)
    angle = _uniform(gen, shape1, 0.0, 3.14)
    amp = _uniform(gen, shape1, 20.0, 90.0)
    waves = amp * torch.sin(freq * (xx * torch.cos(angle) + yy * torch.sin(angle)) + phase)

    # fine texture at a second frequency
    freq2 = _uniform(gen, (batch, 1, 1, 3), 0.3, 1.2)
    tex = 25 * torch.sin(freq2 * (xx + 2 * yy))

    # hard-edged rectangle (its amplitude shares the centre row's draw)
    u_cy = torch.rand(shape1, generator=gen, device=dev)
    cy = (0.2 + 0.6 * u_cy) * height
    cx = _uniform(gen, shape1, 0.2, 0.8) * width
    rect = ((torch.abs(yy - cy) < height / 6) & (torch.abs(xx - cx) < width / 6)).float() \
        * (-70.0 + 140.0 * u_cy)

    # smooth disk (round objects, soft shading)
    dy = _uniform(gen, shape1, 0.2, 0.8) * height
    dx = _uniform(gen, shape1, 0.2, 0.8) * width
    r = _uniform(gen, shape1, 0.1, 0.3) * min(height, width)
    disk = 60.0 * torch.exp(-(((yy - dy) ** 2 + (xx - dx) ** 2) / (r**2 + 1e-6)))

    sigma = _uniform(gen, shape1, 0.0, 6.0)
    noise = sigma * _normal(gen, (batch, height, width, 3))
    return torch.clamp(128.0 + waves + tex + rect + disk + noise, 0, 255)


def synthetic_sr_batch(gen: torch.Generator, batch: int, patch: int = 64):
    """(low_res ``(B,p/2,p/2,3)``, high_res ``(B,p,p,3)``) in [0,255]
    float32: SR pairs through the area downsample. Half the targets are an
    area-downsampled (band-limited) 2x source, half a full-bandwidth crop."""
    from elvis_tpu_torch.ops.resize import resize

    hi = synthetic_frames(gen, batch, patch * 2, patch * 2)
    hi_native = resize(hi, (patch, patch), method="area")
    hi_sharp = hi[:, :patch, :patch]
    pick = _bernoulli(gen, 0.5, (batch, 1, 1, 1))
    hi = torch.where(pick, hi_sharp, hi_native)
    lo = resize(hi, (patch // 2, patch // 2), method="area")
    return lo, hi


def fractal_noise(gen: torch.Generator, batch: int, height: int, width: int) -> torch.Tensor:
    """1/f^alpha spectral noise, alpha per sample in [0.9, 1.6]: white
    spectral noise shaped by ``f^-alpha``, inverse FFT, unit variance; the
    channels share a luminance field plus small independent chroma.
    ``(B,H,W,3)``, about unit std."""
    dev = gen.device
    fy = torch.fft.fftfreq(height, device=dev)[:, None]
    fx = torch.fft.fftfreq(width, device=dev)[None, :]
    f = torch.sqrt(fy**2 + fx**2)
    f[0, 0] = 1.0  # keep DC finite

    alpha = _uniform(gen, (batch, 1, 1, 1), 0.9, 1.6)
    spec = _normal(gen, (batch, height, width, 2, 2))
    z = torch.complex(spec[..., 0], spec[..., 1])  # (B,H,W,2): luma + chroma seed
    filt = f[None, :, :, None] ** (-alpha)
    img = torch.fft.ifft2(z * filt, dim=(1, 2)).real
    img = img / (img.std(dim=(1, 2), keepdim=True, unbiased=False) + 1e-6)
    luma, chroma = img[..., :1], img[..., 1:]
    mix = _uniform(gen, (batch, 1, 1, 3), -0.35, 0.35)
    return luma + mix * chroma


def dead_leaves(gen: torch.Generator, batch: int, height: int, width: int,
                num_shapes: int = 80) -> torch.Tensor:
    """Dead-leaves occlusion model (power-law object sizes, occlusion: a 1/f
    spectrum and sharp scale-invariant edges) over a fractal-textured
    background. ``(B,H,W,3)`` float32 in [0, 255]."""
    dev = gen.device
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    k, b = num_shapes, batch
    cy = _uniform(gen, (k, b), -0.1, 1.1) * height
    cx = _uniform(gen, (k, b), -0.1, 1.1) * width
    # r^-3 size density (classic dead leaves): r = rmin / sqrt(u)
    u = _uniform(gen, (k, b), 1e-3, 1.0)
    r = torch.clamp(4.0 / torch.sqrt(u), 2.0, 0.6 * min(height, width))
    # elongation down to 0.12 gives thin structures (branches, strokes)
    aspect = torch.exp(_uniform(gen, (k, b), -2.1, 0.0))
    theta = _uniform(gen, (k, b), 0.0, 3.14159)
    is_disk = _bernoulli(gen, 0.7, (k, b))
    # correlated natural colours: a shared grey level plus small chroma
    gray = _uniform(gen, (k, b, 1), 15.0, 240.0)
    color = torch.clamp(gray + 28.0 * _normal(gen, (k, b, 3)), 0.0, 255.0)

    img = 128.0 + 30.0 * fractal_noise(gen, batch, height, width)
    for i in range(k):
        dy = yy[None] - cy[i][:, None, None]  # (B,H,W)
        dx = xx[None] - cx[i][:, None, None]
        c, s = torch.cos(theta[i])[:, None, None], torch.sin(theta[i])[:, None, None]
        ry = (c * dy - s * dx) / (r[i] * aspect[i])[:, None, None]
        rx = (s * dy + c * dx) / r[i][:, None, None]
        mask = torch.where(is_disk[i][:, None, None], ry**2 + rx**2 < 1.0,
                           (torch.abs(ry) < 0.9) & (torch.abs(rx) < 0.9))
        img = torch.where(mask[..., None], color[i][:, None, None, :], img)
    return torch.clamp(img, 0.0, 255.0)


def _illumination(gen: torch.Generator, batch: int, height: int, width: int, sigma_max: float):
    """A linear illumination ramp (the same gradient on both axes, as the
    JAX package's one key gives) plus sensor noise up to ``sigma_max``."""
    dev = gen.device
    g = _uniform(gen, (batch, 1, 1, 1), -18.0, 18.0)
    yy = torch.linspace(-1, 1, height, device=dev)[None, :, None, None]
    xx = torch.linspace(-1, 1, width, device=dev)[None, None, :, None]
    sigma = _uniform(gen, (batch, 1, 1, 1), 0.0, sigma_max)
    return g * yy + g * xx + sigma * _normal(gen, (batch, height, width, 3))


def natural_frames(gen: torch.Generator, batch: int, height: int, width: int) -> torch.Tensor:
    """The SR training corpus: dead-leaves structure, in-object fractal
    texture, smooth illumination and sensor noise."""
    base = dead_leaves(gen, batch, height, width)
    tex_amp = _uniform(gen, (batch, 1, 1, 1), 0.0, 22.0)
    tex = tex_amp * fractal_noise(gen, batch, height, width)
    return torch.clamp(base + tex + _illumination(gen, batch, height, width, 3.0), 0.0, 255.0)


def structured_frames(gen: torch.Generator, batch: int, height: int, width: int) -> torch.Tensor:
    """Text- and architecture-like procedural content, one of three hard-
    edged periodic families per sample: a lattice (windows, tile, brick),
    glyph rows (a random ink grid at a random scale, masked into lines and
    words), thin gratings (railings, branches, ridges). Finished as
    ``natural_frames``. ``(B,H,W,3)`` float32 in [0, 255]."""
    dev = gen.device
    b = batch
    yy = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    s3 = (b, 1, 1)

    def square(t, duty):
        return ((t - torch.floor(t)) < duty).float()

    # family 0: lattice (windows / tile / brick)
    py = _uniform(gen, s3, 5.0, 40.0)
    px = _uniform(gen, s3, 5.0, 40.0)
    duty_y = _uniform(gen, s3, 0.45, 0.9)
    duty_x = _uniform(gen, s3, 0.45, 0.9)
    ang = _uniform(gen, s3, -0.15, 0.15)
    c, s = torch.cos(ang), torch.sin(ang)
    u = (c * xx - s * yy) / px
    v = (s * xx + c * yy) / py
    brick = _bernoulli(gen, 0.5, s3).float()
    u = u + 0.5 * brick * torch.remainder(torch.floor(v), 2.0)
    lattice = square(u, duty_x) * square(v, duty_y)

    # family 1: glyph rows (text), 2-7 px per ink cell
    hc, wc = max(height // 4, 8), max(width // 4, 8)
    bits = _bernoulli(gen, 0.55, (b, hc, wc)).float()
    sy = _uniform(gen, (b,), 0.15, 0.5)
    sx = _uniform(gen, (b,), 0.15, 0.5)
    iy = (torch.arange(height, dtype=torch.float32, device=dev)[None] * sy[:, None]
          ).to(torch.int64) % hc
    ix = (torch.arange(width, dtype=torch.float32, device=dev)[None] * sx[:, None]
          ).to(torch.int64) % wc
    glyph = bits[torch.arange(b, device=dev)[:, None, None], iy[:, :, None], ix[:, None, :]]
    line_pitch = _uniform(gen, s3, 7.0, 26.0)
    word_pitch = _uniform(gen, s3, 20.0, 80.0)
    glyph = glyph * square(yy / line_pitch, 0.62) * square(xx / word_pitch, 0.86)

    # family 2: thin gratings (railings / branches / ridges)
    ga = _uniform(gen, s3, 0.0, 3.14159)
    gp = _uniform(gen, s3, 4.0, 28.0)
    gd = _uniform(gen, s3, 0.1, 0.35)
    t1 = (torch.cos(ga) * xx + torch.sin(ga) * yy) / gp
    ga2 = ga + _uniform(gen, s3, 0.8, 2.3)
    gp2 = _uniform(gen, s3, 6.0, 40.0)
    t2 = (torch.cos(ga2) * xx + torch.sin(ga2) * yy) / gp2
    second = _bernoulli(gen, 0.5, s3).float()
    grating = torch.maximum(square(t1, gd), second * square(t2, gd))

    fam = _randint(gen, 0, 3, s3)
    mask = torch.where(fam == 0, lattice, torch.where(fam == 1, glyph, grating))

    ink = _uniform(gen, (b, 1, 1, 3), 5.0, 250.0)
    paper = _uniform(gen, (b, 1, 1, 3), 5.0, 250.0)
    # keep ink / paper contrast real (>= 60 luma apart)
    gap = torch.abs(ink.mean(-1, keepdim=True) - paper.mean(-1, keepdim=True))
    ink = torch.where(gap < 60.0, torch.where(paper > 127.0, paper - 90.0, paper + 90.0), ink)
    img = paper + (ink - paper) * mask[..., None]
    tex = 8.0 * fractal_noise(gen, batch, height, width)
    return torch.clamp(img + tex + _illumination(gen, batch, height, width, 2.5), 0.0, 255.0)


def codec_noise_at(frames: torch.Tensor, qp: torch.Tensor, apply: torch.Tensor,
                   block: int = 8) -> torch.Tensor:
    """``codec_noise`` for given draws: blockwise DCT quantize / dequantize
    at the per-sample ``qp`` (``(B,)`` float, H.264-style ``Qstep =
    2^((QP-4)/6)``) where ``apply`` (``(B,)`` bool) holds; the other samples
    pass through."""
    from elvis_tpu_torch.core.blocks import combine_blocks, split_into_blocks
    from elvis_tpu_torch.ops.dct import block_dct2, block_idct2

    qstep = torch.exp2((qp.float().reshape(-1, 1, 1, 1, 1, 1) - 4.0) / 6.0)
    blocks = split_into_blocks(frames.float() - 128.0, block)  # (B,By,Bx,b,b,3)
    planes = torch.movedim(blocks, -1, 1)  # (B,3,By,Bx,b,b)
    levels = torch.round(block_dct2(planes) / qstep)
    recon = block_idct2(levels * qstep)
    out = torch.clamp(combine_blocks(torch.movedim(recon, 1, -1)) + 128.0, 0.0, 255.0)
    return torch.where(apply.reshape(-1, 1, 1, 1), out, frames.float())


def codec_noise(gen: torch.Generator, frames: torch.Tensor, block: int = 8,
                qp_min: float = 16.0, qp_max: float = 38.0, prob: float = 0.7) -> torch.Tensor:
    """Codec-artifact augmentation: blockwise DCT quantization at a random
    QP per sample in ``[qp_min, qp_max)``, applied with probability
    ``prob``. The restorers see DECODED frames at inference, so training
    inputs carry matching blocking and ringing. With a milder QP range on
    CLEAN sources it is the JPEG-ground-truth family."""
    n = frames.shape[0]
    qp = _uniform(gen, (n,), qp_min, qp_max)
    apply = _bernoulli(gen, prob, (n,))
    return codec_noise_at(frames, qp, apply, block)


def synthetic_video_batch(gen: torch.Generator, frames: int, height: int,
                          width: int) -> torch.Tensor:
    """A short clip with coherent motion (a wrapped roll of one frame)."""
    base = synthetic_frames(gen, 1, height, width)[0]
    shifts = torch.cumsum(_randint(gen, -3, 4, (frames, 2)), dim=0).tolist()
    return torch.stack([torch.roll(base, (sy, sx), dims=(0, 1)) for sy, sx in shifts])


def _pan(scene: torch.Tensor, steps: torch.Tensor, pad: int, height: int,
         width: int) -> torch.Tensor:
    offsets = (torch.clamp(torch.cumsum(steps, dim=0), -pad, pad) + pad).tolist()
    return torch.stack([scene[oy: oy + height, ox: ox + width] for oy, ox in offsets])


def natural_video_batch(gen: torch.Generator, frames: int, height: int, width: int,
                        max_pan: int = 3) -> torch.Tensor:
    """A panning clip over natural-statistics content: a wide dead-leaves
    scene through a drifting window (new content enters at the edge)."""
    pad = max_pan * frames
    scene = natural_frames(gen, 1, height + 2 * pad, width + 2 * pad)[0]
    return _pan(scene, _randint(gen, -max_pan, max_pan + 1, (frames, 2)), pad, height, width)


def _require(module: str, package: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError(f"photo_patch_pool needs {package}, which is not installed; "
                          "train on the procedural sources (photo_fraction=0) instead") from exc


@functools.lru_cache(maxsize=16)
def photo_patch_pool(patch: int = 64, train: bool = True, pool_size: int = 2048, seed: int = 0,
                     photos: tuple = ("china", "flower")) -> np.ndarray:
    """``(pool_size, patch, patch, 3)`` float32 [0,255] patches from real
    photographs shipped inside installed packages: scikit-learn's
    ``china`` and ``flower`` by default; matplotlib's ``grace_hopper``;
    gymnasium_robotics' textures ``wood``, ``tile``, ``marble``, ``metal``;
    dm_control's ``sky``, ``grass``, ``fur`` and the adroit hand's
    ``darkwood``, ``silver``, ``skin``. Patches come from a 5-level Lanczos
    pyramid with the 8 dihedral transforms; ``train=True`` takes the
    photo's left columns, ``train=False`` the held-out right strip. A host
    numpy array, equal to the JAX package's (the same PIL resize and numpy
    draws). Raises ``ImportError`` naming a missing package."""
    import contextlib
    import io
    import os

    Image = _require("PIL.Image", "PIL (Pillow)")
    textures = {"wood": "wood1.png", "tile": "tile1.png", "marble": "marble1.png",
                "metal": "metal1.png"}
    extra = {
        "sky": ("dm_control", "locomotion/arenas/assets/outdoor_natural/OutdoorSkybox2048.png"),
        "grass": ("dm_control", "locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png"),
        "fur": ("dm_control", "suite/dog_assets/skin_texture.png"),
        "darkwood": ("gymnasium_robotics",
                     "envs/assets/adroit_hand/resources/textures/darkwood.png"),
        "silver": ("gymnasium_robotics",
                   "envs/assets/adroit_hand/resources/textures/silverRaw.png"),
        "skin": ("gymnasium_robotics", "envs/assets/adroit_hand/resources/textures/skin.png"),
    }

    def pkg_dir(name):
        with contextlib.redirect_stdout(io.StringIO()):  # some print a notice
            return os.path.dirname(_require(name, name).__file__)

    def open_photo(name):
        if name == "grace_hopper":
            path = os.path.join(pkg_dir("matplotlib"), "mpl-data", "sample_data",
                                "grace_hopper.jpg")
            return Image.open(path).convert("RGB"), 480
        if name in textures:
            path = os.path.join(pkg_dir("gymnasium_robotics"), "envs", "assets",
                                "kitchen_franka", "kitchen_assets", "textures", textures[name])
        elif name in extra:
            path = os.path.join(pkg_dir(extra[name][0]), extra[name][1])
        else:
            path = os.path.join(pkg_dir("sklearn"), "datasets", "images", f"{name}.jpg")
            return Image.open(path).convert("RGB"), 480
        img = Image.open(path).convert("RGB")
        return img, int(0.75 * img.size[0])

    arrs = []
    for name in photos:
        img, val_x = open_photo(name)
        w, h = img.size
        for s in (1.0, 0.85, 0.7, 0.55, 0.4):
            im2 = img if s == 1.0 else img.resize((int(w * s), int(h * s)), Image.LANCZOS)
            a = np.asarray(im2, np.float32)
            cut = int(val_x * s)
            a = a[:, :cut] if train else a[:, cut:]
            if a.shape[0] >= patch and a.shape[1] >= patch:
                arrs.append(a)
    if not arrs:
        raise ValueError(f"no source region fits a {patch}px patch")
    rng = np.random.default_rng(seed)
    out = np.empty((pool_size, patch, patch, 3), np.float32)
    for i in range(pool_size):
        a = arrs[int(rng.integers(len(arrs)))]
        y = int(rng.integers(0, a.shape[0] - patch + 1))
        x = int(rng.integers(0, a.shape[1] - patch + 1))
        p = a[y: y + patch, x: x + patch]
        k = int(rng.integers(8))
        if k & 1:
            p = p[:, ::-1]
        if k & 2:
            p = p[::-1]
        if k & 4:
            p = np.swapaxes(p, 0, 1)
        out[i] = p
    return out


def photo_video_batch(gen: torch.Generator, pool: torch.Tensor, frames: int, height: int,
                      width: int, max_pan: int = 3) -> torch.Tensor:
    """A camera pan over a REAL photograph: one scene of ``pool`` (``(K,
    height+2*pad, width+2*pad, 3)``, ``pad = max_pan*frames``; build it
    with ``photo_patch_pool(size + 2*max_pan*frames, ...)``) through a
    drifting window."""
    pad = max_pan * frames
    scene = pool[int(_randint(gen, 0, pool.shape[0], ()))]
    return _pan(scene, _randint(gen, -max_pan, max_pan + 1, (frames, 2)), pad, height, width)

