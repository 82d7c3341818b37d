"""LPIPS-class perceptual distance (port of ``elvis_tpu.metrics.perceptual``).

The backbone is the JAX package's trained ``PerceptualNet`` (a 5-stage
strided conv stack, AlexNet-shaped receptive-field ladder), whose weights
ship as ``elvis_tpu_torch/weights/perceptual.npz`` (exported from
``checkpoints/perceptual``). The distance is the LPIPS formula: per-layer
unit-normalized features, squared difference, mean over the layer, mean
over the five layers. The metric runs in float32 at full precision (no
TF32 in the convolutions).

The JAX package falls back to random features from ``PRNGKey(1234)`` when
its checkpoint is missing; the port cannot reproduce that draw and raises
instead.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from elvis_tpu_torch.device import full_fp32, resolve_device

__all__ = ["PerceptualNet", "lpips_distance", "lpips_pairwise", "ensure_loaded",
           "load_perceptual"]

_STRIDES = (2, 2, 2, 1, 1)
_KERNELS = (7, 5, 3, 3, 3)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax ``padding="SAME"``: ceil(n/s) outputs, the odd pixel of the
    padding after (k=7, s=2 on an even size pads 2 before and 3 after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class PerceptualNet(nn.Module):
    """5-stage strided conv stack; ``forward`` takes ``(N,H,W,3)`` and
    returns the five ReLU feature maps as ``(N,C,H',W')``."""

    def __init__(self, features: Tuple[int, ...] = (32, 64, 128, 128, 128)):
        super().__init__()
        self.features = tuple(features)
        cin = 3
        for i, (f, k) in enumerate(zip(self.features, _KERNELS)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, f, k, stride=_STRIDES[i]))
            cin = f

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        feats = []
        for i, (k, s) in enumerate(zip(_KERNELS, _STRIDES)):
            top, bottom = _same_pad(h.shape[-2], k, s)
            left, right = _same_pad(h.shape[-1], k, s)
            h = F.relu(getattr(self, f"conv{i}")(F.pad(h, (left, right, top, bottom))))
            feats.append(h)
        return feats


_models: Dict[str, PerceptualNet] = {}


def load_perceptual(path: str, device: "str | torch.device" = "cuda") -> PerceptualNet:
    """The backbone from a port weights file, on ``device``."""
    from elvis_tpu_torch.models.io import params_from_flax, read_npz

    tree, _ = read_npz(path)
    params = tree.get("params", tree)
    features = tuple(int(params[f"conv{i}"]["kernel"].shape[-1]) for i in range(5))
    model = PerceptualNet(features)
    model.load_state_dict(params_from_flax(tree))
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def ensure_loaded(device: "str | torch.device" = "cuda") -> PerceptualNet:
    """The shipped backbone on ``device``, loaded once per device. Raises
    when ``weights/perceptual.npz`` is missing."""
    dev = resolve_device(device)
    key = str(dev)
    if key not in _models:
        from elvis_tpu_torch.models.io import weights_path

        path = weights_path("perceptual")
        if path is None:
            raise FileNotFoundError(
                "elvis_tpu_torch/weights/perceptual.npz is missing: export it with "
                "`python tests/test_torch_weights.py --write`")
        _models[key] = load_perceptual(path, dev)
    return _models[key]


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt((f ** 2).sum(dim=1, keepdim=True) + 1e-10)


def lpips_pairwise(model: PerceptualNet, ref: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """The LPIPS formula for a given backbone: unit-normalized per-layer
    feature L2, layer mean. ``(N,H,W,3)`` [0,255] pairs -> (N,)."""
    r = ref.float() / 127.5 - 1.0
    d = dec.float() / 127.5 - 1.0
    with full_fp32():
        fr = model(r)
        fd = model(d)
    dists = [((_unit_normalize(a) - _unit_normalize(b)) ** 2).mean(dim=(1, 2, 3))
             for a, b in zip(fr, fd)]
    return torch.stack(dists, dim=0).mean(dim=0)


def lpips_distance(ref: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """``(N,H,W,3)`` [0,255] pairs -> (N,) perceptual distances, with the
    shipped backbone on the tensors' device."""
    with torch.inference_mode():
        return lpips_pairwise(ensure_loaded(ref.device), ref, dec)
