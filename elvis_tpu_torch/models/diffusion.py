"""DiffusionRestorer — conditional diffusion restoration, the InstantIR slot
(port of ``elvis_tpu.models.diffusion``).

  * ``_CondUNet``: a compact pixel-space UNet that predicts the CLEAN
    image as a residual over the degraded conditioning; its float32 head
    (named ``eps`` as in the checkpoint) is zero-initialized, so an
    untrained model is exactly the identity restorer;
  * sampling starts from the degraded frame noised to ``t_start`` of a
    cosine schedule (SDEdit) and runs DDIM over a fixed integer timestep
    schedule;
  * ``restore_adaptive``: one conditioned trajectory; a block of strength
    ``s`` takes the x0 prediction after ``s * steps_per_round`` steps
    (strength 0 keeps the input);
  * ``loss``: the training objective, the x0-prediction mean square error
    on a noised random mix of the clean and the degraded frame.

Randomness: the SDEdit noise is an argument (``noise=``), or drawn from a
``torch.Generator`` the caller passes (``generator=``; a fresh generator
seeded 0 when neither is given). The JAX package draws
``jax.random.normal(key, cond.shape)``, which PyTorch cannot reproduce:
the parity tests hand both packages the same noise array. ``loss`` takes
its timesteps, mix weights and noise as arguments (``t=``, ``gamma=``,
``noise=``) or draws them from the ``generator`` it is given.

Public layout is NHWC: frames ``(N, H, W, 3)`` in [0, 255]. Numerics
mirror the flax model: the body (and the time-embedding dense layer) in
``dtype`` (bf16 by default), the head in float32 with TF32 off, the
sampler's arithmetic in float32. The stride-2 conv pads as flax's
``SAME`` does and the pixel shuffle lays channels out as ``(dy, dx, c)``:
both helpers are the deblur net's. H and W must be even.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from elvis_tpu_torch.core.blocks import upsample_map
from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.models.deblur_unet import _pixel_shuffle
from elvis_tpu_torch.models.inpaint_net import _conv_nhwc

__all__ = ["DiffusionRestorer", "ddim_timesteps"]


class _CondUNet(nn.Module):
    """Parameter names follow the flax tree: ``Dense_0``, ``in``, ``d0``,
    ``m0``, ``m1``, ``u0``, ``out0``, ``eps``."""

    def __init__(self, features: int = 32, embed_dim: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.dtype = features, dtype
        f = features
        self.Dense_0 = nn.Linear(embed_dim, 2 * f)
        setattr(self, "in", nn.Conv2d(6, f, 3, padding=1))  # 'in' is a keyword
        self.d0 = nn.Conv2d(f, 2 * f, 3, stride=2)
        self.m0 = nn.Conv2d(2 * f, 2 * f, 3, padding=1)
        self.m1 = nn.Conv2d(2 * f, 2 * f, 3, padding=1)
        self.u0 = nn.Conv2d(2 * f, 4 * f, 3, padding=1)
        self.out0 = nn.Conv2d(2 * f, f, 3, padding=1)
        self.eps = nn.Conv2d(f, 3, 3, padding=1)
        nn.init.zeros_(self.eps.weight)  # identity until trained, as in flax
        nn.init.zeros_(self.eps.bias)

    def forward(self, x_noisy: torch.Tensor, cond: torch.Tensor,
                t_embed: torch.Tensor) -> torch.Tensor:
        """x_noisy / cond ``(N,H,W,3)`` in [-1,1]; t_embed ``(N, E)`` ->
        the float32 residual ``(N,H,W,3)``."""
        dt = self.dtype
        h = torch.cat([x_noisy, cond], dim=-1).to(dt)
        te = F.linear(t_embed.to(dt), self.Dense_0.weight.to(dt), self.Dense_0.bias.to(dt))
        with full_fp32():  # binds only where the body or the head is float32
            h = F.leaky_relu(_conv_nhwc(getattr(self, "in"), h, dt), 0.2)
            s0 = h
            h = F.leaky_relu(_conv_nhwc(self.d0, h, dt) + te[:, None, None, :], 0.2)
            h = F.leaky_relu(_conv_nhwc(self.m0, h, dt), 0.2)
            h = F.leaky_relu(_conv_nhwc(self.m1, h, dt), 0.2)
            h = torch.cat([_pixel_shuffle(_conv_nhwc(self.u0, h, dt)), s0], dim=-1)
            h = F.leaky_relu(_conv_nhwc(self.out0, h, dt), 0.2)
            return _conv_nhwc(self.eps, h.float(), torch.float32)


def _time_embedding(t: torch.Tensor, dim: int = 32) -> torch.Tensor:
    """Sinusoidal embedding ``(N,) -> (N, dim)`` float32: sines then cosines."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(10000.0) * ar / half)
    ang = t[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def ddim_timesteps(t0: int, steps: int) -> List[int]:
    """The sampler's integer schedule, ``jnp.linspace(t0, 1, steps)``
    truncated toward zero, with the float32 arithmetic of the JAX
    package's compiled linspace: ``t0 * (1 - s) + s`` with ``s = i * r``
    and ``r`` the float32 reciprocal of ``steps - 1``. ``torch.linspace``
    rounds differently and moves some timesteps by one."""
    if steps == 1:
        return [int(t0)]
    f32 = np.float32
    s = np.arange(steps - 1, dtype=f32) * (f32(1) / f32(steps - 1))
    inner = (f32(t0) * (f32(1) - s) + f32(1) * s).astype(f32)
    return [int(v) for v in inner.astype(np.int32)] + [1]


class DiffusionRestorer(nn.Module):
    """The UNet with a cosine schedule, the DDIM sampler and the adaptive
    block-exit restore."""

    def __init__(self, features: int = 32, num_train_steps: int = 1000):
        super().__init__()
        self.unet = _CondUNet(features=features)
        self.num_train_steps = num_train_steps
        t = np.arange(num_train_steps + 1, dtype=np.float64) / num_train_steps
        alpha_bar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        # host float32 copy: the schedule's scalars are read per step
        self.alpha_bar = (alpha_bar / alpha_bar[0]).astype(np.float32)

    def _predict_x0(self, x: torch.Tensor, cond: torch.Tensor, t: int) -> torch.Tensor:
        tb = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        res = self.unet(x, cond, _time_embedding(tb))
        return torch.clamp(cond + res, -1.0, 1.0)

    def _x0_path(self, cond: torch.Tensor, steps: int, t_start: float,
                 noise: torch.Tensor) -> Iterator[torch.Tensor]:
        """The DDIM trajectory from ``cond`` (in [-1, 1]) noised to
        ``t_start`` with ``noise``: yields each step's x0 prediction in
        [-1, 1], one at a time (the caller keeps what it reads)."""
        f32 = np.float32
        t0 = int(t_start * (self.num_train_steps - 1))
        ab0 = self.alpha_bar[t0]
        x = float(np.sqrt(ab0)) * cond + float(np.sqrt(f32(1) - ab0)) * noise.float()
        dt = max(t0 // steps, 1)
        for t in ddim_timesteps(t0, steps):
            x0_pred = self._predict_x0(x, cond, t)
            ab_t, ab_prev = self.alpha_bar[t], self.alpha_bar[max(t - dt, 0)]
            eps_impl = (x - float(np.sqrt(ab_t)) * x0_pred) / float(np.sqrt(f32(1) - ab_t))
            x = float(np.sqrt(ab_prev)) * x0_pred + float(np.sqrt(f32(1) - ab_prev)) * eps_impl
            yield x0_pred

    def loss(self, clean: torch.Tensor, degraded: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             t: Optional[torch.Tensor] = None, gamma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """x0-prediction mean square error on TRAJECTORY-CONSISTENT inputs:
        the net sees ``gamma * clean + (1 - gamma) * degraded`` (in [-1, 1])
        noised to a random ``t`` in [1, num_train_steps), the states a
        restoration trajectory visits, and must predict the clean frame
        from it and the degraded conditioning. ``t`` ``(N,)`` int, ``gamma``
        ``(N,1,1,1)`` in [0, 1) and ``noise`` (clean's shape) are drawn
        from ``generator`` where not given, in that order. ``params``
        (the UNet's ``{name: tensor}``) replaces the UNet's own parameters
        (``torch.func.functional_call``), as a trainer passes them."""
        n = clean.shape[0]
        dev = clean.device
        x0 = clean.float() / 127.5 - 1.0
        cond = degraded.float() / 127.5 - 1.0
        if generator is None and (t is None or gamma is None or noise is None):
            # a fixed default seed would repeat the same draws every step
            raise ValueError("DiffusionRestorer.loss: pass t, gamma and noise, or a "
                             "generator to draw them from")
        if t is None:
            t = torch.randint(1, self.num_train_steps, (n,), generator=generator, device=dev)
        if gamma is None:
            gamma = torch.rand((n, 1, 1, 1), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev)
        t = t.to(dev).long()
        ab = torch.as_tensor(self.alpha_bar, device=dev)[t][:, None, None, None]
        base = gamma.to(dev).float() * x0 + (1.0 - gamma.to(dev).float()) * cond
        x_noisy = torch.sqrt(ab) * base + torch.sqrt(1 - ab) * noise.to(dev).float()
        args = (x_noisy, cond, _time_embedding(t))
        res = self.unet(*args) if params is None else functional_call(self.unet, params, args)
        x0_pred = torch.clamp(cond + res, -1.0, 1.0)
        return torch.mean((x0_pred - x0) ** 2)

    @staticmethod
    def _noise(cond: torch.Tensor, noise: Optional[torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
        if noise is not None:
            return noise.to(cond.device)
        if generator is None:
            generator = torch.Generator(device=cond.device).manual_seed(0)
        return torch.randn(cond.shape, generator=generator, device=cond.device)

    @torch.inference_mode()
    def sample(self, degraded: torch.Tensor, steps: int = 8, t_start: float = 0.4,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Whole-frame restoration: the trajectory's last x0 prediction,
        ``(N,H,W,3)`` float32 in [0, 255]."""
        cond = degraded.float() / 127.5 - 1.0
        x0 = None
        for x0 in self._x0_path(cond, steps, t_start, self._noise(cond, noise, generator)):
            pass
        return torch.clamp((x0 + 1.0) * 127.5, 0.0, 255.0)

    @torch.inference_mode()
    def restore_adaptive(self, degraded: torch.Tensor, strength_map: torch.Tensor,
                         block_size: int = 8, max_rounds: int = 10, steps_per_round: int = 2,
                         t_start: float = 0.4, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A block of strength ``s`` (clipped to [0, max_rounds]) takes the
        x0 prediction after ``s * steps_per_round`` steps of one trajectory;
        strength 0 keeps the input. Each round's prediction is selected
        into the output as the loop reaches it, so the trajectory is never
        held whole. ``(N,H,W,3)`` float32 in [0, 255]."""
        cond = degraded.float() / 127.5 - 1.0
        counters = torch.clamp(strength_map.to(torch.int32), 0, max_rounds)
        steps = max_rounds * steps_per_round
        out = cond
        path = self._x0_path(cond, steps, t_start, self._noise(cond, noise, generator))
        for s, x0 in enumerate(path, start=1):
            if s % steps_per_round == 0:
                pix = upsample_map(counters == s // steps_per_round, block_size)[..., None]
                out = torch.where(pix, x0, out)
        return torch.clamp((out + 1.0) * 127.5, 0.0, 255.0)
