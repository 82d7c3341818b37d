"""Trainer: sharded train steps (DP over the batch, TP over output
channels), AdamW with ``optax.adamw``'s arithmetic, and checkpoints in the
port's ``.npz`` weights format (port of ``elvis_tpu.train.trainer``).

The JAX package compiles one ``jit`` over a ``Mesh``. Here one controller
runs the step on a :class:`~elvis_tpu_torch.parallel.mesh.Mesh`:

  * the batch is split over the ``data`` axis; each shard computes its part
    of the GLOBAL mean loss on its device (``loss * n_shard / N``), and the
    gradients are summed across shards, so the update is the unsharded one;
  * on a ``tensor`` axis a weight whose output-channel axis (axis 0 in
    torch's layout: OIHW convs, ``(out, in)`` dense kernels) divides the
    axis size is stored as shards on those devices (``partition_params``);
    everything else is replicated. The AdamW moments mirror their
    parameter's placement, and the update is elementwise, so each shard
    updates its own slice.

Parameters are held as ``{name: [tensor, ...]}``: one tensor for a
replicated parameter (on the mesh's first device; each data shard gets a
copy per step), one per tensor-axis device for a sharded one. A loss
function sees full parameters on its shard's device: ``loss_fn(params,
batch)`` with ``params`` a ``{name: tensor}`` dict for
``torch.func.functional_call``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["TrainState", "AdamWState", "AdamW", "adamw", "warmup_cosine_decay_schedule",
           "partition_params", "make_sharded_train_step", "Trainer"]

Params = Dict[str, List[torch.Tensor]]
Schedule = Union[float, Callable[[int], float]]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` over the remaining ``decay_steps -
    warmup_steps``. Evaluated in float32, as optax does."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, decay_steps - warmup_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay_steps - warmup_steps),
                                             dtype=f32))
        return float(f32(peak_value) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))

    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class AdamW:
    """``optax.adamw``'s arithmetic: ``mu``, ``nu`` updated as optax's
    moments, bias-corrected at the incremented count, ``eps`` outside the
    square root, decoupled weight decay on every parameter, and the whole
    update scaled by the learning rate read at the count BEFORE the
    increment (so a warmup schedule's first step has learning rate 0)."""

    learning_rate: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Params) -> AdamWState:
        zeros = {n: [torch.zeros_like(c) for c in chunks] for n, chunks in params.items()}
        return AdamWState(0, zeros, {n: [z.clone() for z in zs] for n, zs in zeros.items()})

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params):
        """(new params, new state); the counterpart of ``optimizer.update``
        followed by ``optax.apply_updates``."""
        count_inc = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count_inc))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count_inc))
        lr = self.lr(state.count)
        new_p, new_mu, new_nu = {}, {}, {}
        for name, chunks in params.items():
            new_p[name], new_mu[name], new_nu[name] = [], [], []
            for p, g, m, v in zip(chunks, grads[name], state.mu[name], state.nu[name]):
                m = (1 - self.b1) * g + self.b1 * m
                v = (1 - self.b2) * (g * g) + self.b2 * v
                upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.weight_decay * p
                new_p[name].append(p + (-lr) * upd)
                new_mu[name].append(m)
                new_nu[name].append(v)
        return new_p, AdamWState(count_inc, new_mu, new_nu)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


def partition_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                     tensor_axis: str = "tensor") -> Dict[str, Optional[List[torch.device]]]:
    """Per parameter, the devices its output-channel shards live on, or
    None (replicated on the mesh's first device). A weight of two or more
    axes whose axis 0 divides the tensor axis size is sharded; everything
    else (biases, a 3-channel output head on a 2-way axis) is replicated."""
    if tensor_axis not in mesh.shape:
        return {n: None for n in params}
    devs = mesh.axis_devices(tensor_axis)
    return {n: (devs if p.ndim >= 2 and p.shape[0] % len(devs) == 0 else None)
            for n, p in params.items()}


def _gather(chunks: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    if len(chunks) == 1:
        return chunks[0].to(device)
    return torch.cat([c.to(device) for c in chunks])


def make_sharded_train_step(loss_fn: Callable, optimizer: AdamW, mesh: Mesh,
                            data_axis: str = "data", tensor_axis: str = "tensor"):
    """``loss_fn(params, batch) -> scalar tensor``, ``params`` a ``{name:
    tensor}`` dict of full parameters on the shard's device. Returns
    ``(train_step, shard_state, shard_batch)``:
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``,
    with the batch split over ``data_axis``; ``shard_state(params,
    opt_state)`` places full parameters (and the optimizer's moments beside
    them) by ``partition_params``; ``shard_batch(batch)`` splits a batch
    into its per-shard parts on their devices."""
    home = mesh.devices.flat[0]
    data_devs = mesh.axis_devices(data_axis) if data_axis in mesh.shape else [home]

    def shard_batch(batch: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        n = int(batch[0].shape[0])
        if n % len(data_devs):
            raise ValueError(f"batch of {n} not divisible by the data axis {len(data_devs)}")
        return [[x.chunk(len(data_devs))[i].to(d) for x in batch]
                for i, d in enumerate(data_devs)]

    def shard_state(params: Dict[str, torch.Tensor], opt_state: Optional[AdamWState] = None):
        placement = partition_params(params, mesh, tensor_axis)

        def place(name, t):
            devs = placement[name]
            if devs is None:
                return [t.detach().to(home)]
            return [c.detach().to(d) for c, d in zip(t.chunk(len(devs)), devs)]

        sharded = {n: place(n, p) for n, p in params.items()}
        if opt_state is None:
            return sharded, optimizer.init(sharded)
        moments = [{n: place(n, _gather(m[n], home)) for n in params}
                   for m in (opt_state.mu, opt_state.nu)]
        return sharded, AdamWState(opt_state.count, *moments)

    def train_step(params: Params, opt_state: AdamWState, batch: Sequence[torch.Tensor]):
        parts = shard_batch(batch)
        n = sum(int(p[0].shape[0]) for p in parts)
        grads = {name: [torch.zeros_like(c) for c in chunks] for name, chunks in params.items()}
        loss_total = torch.zeros((), device=home)
        for part in parts:
            dev = part[0].device
            full = {name: _gather(chunks, dev).detach().requires_grad_(True)
                    for name, chunks in params.items()}
            # this shard's part of the global mean
            loss = loss_fn(full, part) * (int(part[0].shape[0]) / n)
            gs = torch.autograd.grad(loss, list(full.values()), allow_unused=True)
            with torch.no_grad():
                for (name, chunks), g in zip(params.items(), gs):
                    if g is None:
                        continue
                    pieces = g.chunk(len(chunks)) if len(chunks) > 1 else (g,)
                    for acc, piece in zip(grads[name], pieces):
                        acc += piece.to(acc.device)
                loss_total += loss.detach().to(home)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, loss_total

    return train_step, shard_state, shard_batch


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamWState
    step: int = 0


class Trainer:
    """A training loop over ``model``'s parameters: AdamW (``learning_rate``
    a float or a schedule of the step count), the sharded step on ``mesh``
    (default: every device of ``device``'s type, one ``data`` axis), and
    checkpoints in the port's ``.npz`` weights format under ``ckpt_dir``.
    The model's own parameters are the initial state; ``sync_model`` writes
    the trained ones back into it."""

    def __init__(self, loss_fn: Callable, model: nn.Module, mesh: Optional[Mesh] = None,
                 learning_rate: Schedule = 2e-4, ckpt_dir: Optional[str] = None,
                 weight_decay: float = 1e-4, device: "str | torch.device" = "cuda"):
        dev = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(device_type=dev.type)
        self.model = model
        self.optimizer = adamw(learning_rate, weight_decay=weight_decay)
        self.step_fn, self._shard_state, _ = make_sharded_train_step(
            loss_fn, self.optimizer, self.mesh)
        params, opt_state = self._shard_state(dict(model.named_parameters()))
        self.state = TrainState(params, opt_state)
        self.ckpt_dir = ckpt_dir

    def step(self, batch: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update on ``batch`` (a tuple of tensors sharing the batch
        axis); returns the loss as a 0-d tensor on the mesh's first device
        (no host synchronisation)."""
        params, opt_state, loss = self.step_fn(self.state.params, self.state.opt_state, batch)
        self.state = TrainState(params, opt_state, self.state.step + 1)
        return loss

    def params(self, device: "torch.device | None" = None) -> Dict[str, torch.Tensor]:
        """The full parameters, gathered on ``device`` (the mesh's first
        device by default)."""
        device = self.mesh.devices.flat[0] if device is None else device
        return {n: _gather(c, device) for n, c in self.state.params.items()}

    def set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Replace the parameters (placed by ``partition_params``), keeping
        the optimizer's moments."""
        placed, _ = self._shard_state(params, self.state.opt_state)
        self.state = dataclasses.replace(self.state, params=placed)

    @torch.no_grad()
    def sync_model(self) -> nn.Module:
        """Copy the trained parameters into ``self.model``; returns it."""
        for name, p in self.model.named_parameters():
            p.copy_(_gather(self.state.params[name], p.device))
        return self.model

    def save(self, tag: str = "latest") -> Optional[str]:
        """``<ckpt_dir>/<tag>.npz`` in the port's weights format (what
        ``models.io.read_npz`` / ``load_srnet`` / ``load_deblur`` read);
        None without a ``ckpt_dir``."""
        if self.ckpt_dir is None:
            return None
        from elvis_tpu_torch.models.io import model_meta, write_npz

        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(self.ckpt_dir, f"{tag}.npz"))
        write_npz(path, self.params(torch.device("cpu")), model_meta(self.model))
        return path

    def load(self, tag: str = "latest") -> Dict[str, torch.Tensor]:
        from elvis_tpu_torch.models.io import params_from_flax, read_npz

        tree, _ = read_npz(os.path.join(self.ckpt_dir, f"{tag}.npz"))
        self.set_params(params_from_flax(tree))
        return self.params()
