"""Weights for the port's models (the counterpart of ``elvis_tpu.models.io``).

The shipped SR checkpoints reach the port as numpy ``.npz`` files under
``elvis_tpu_torch/weights/``: float32 arrays stored under their flax paths
(``params/head/kernel``, ...), plus the model's ``features`` and
``num_convs``. ``params_from_flax`` turns such a tree into a PyTorch
state_dict (HWIO kernels -> OIHW); ``load_srnet`` builds the model.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.models.srnet import SRNetCompact

__all__ = [
    "weights_dir",
    "weights_path",
    "params_from_flax",
    "read_npz",
    "load_srnet",
]


def weights_dir() -> str:
    """The port's committed weights: ``elvis_tpu_torch/weights/``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "weights")


def weights_path(name: str) -> Optional[str]:
    """``weights/<name>.npz`` when it exists, else None."""
    path = os.path.join(weights_dir(), f"{name}.npz")
    return path if os.path.isfile(path) else None


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax param tree of numpy arrays (``{'params': {...}}`` or its inner
    dict) -> an SRNetCompact state_dict. Conv kernels go HWIO -> OIHW; the
    names ``head``, ``conv{i}``, ``up``, ``tail`` carry over."""
    params = tree.get("params", tree)
    state = {}
    for name, leaf in params.items():
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kernel.ndim != 4:
            raise ValueError(f"{name}: expected an HWIO conv kernel, got {kernel.shape}")
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy())
    return state


def read_npz(path: str):
    """``(flax tree of numpy arrays, meta dict)`` from a port weights file."""
    tree: Dict = {}
    meta = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if len(parts) == 1:
                meta[key] = data[key].item()
                continue
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree, meta


def load_srnet(path: str, device: "str | torch.device" = "cuda") -> SRNetCompact:
    """An inference-ready SRNetCompact from a port weights file, on ``device``."""
    dev = resolve_device(device)
    tree, meta = read_npz(path)
    model = SRNetCompact(features=int(meta["features"]), num_convs=int(meta["num_convs"]))
    model.load_state_dict(params_from_flax(tree))
    return model.to(dev).eval().requires_grad_(False)
