"""Weights for the port's models (the counterpart of ``elvis_tpu.models.io``).

The shipped checkpoints reach the port as numpy ``.npz`` files under
``elvis_tpu_torch/weights/``: float32 arrays stored under their flax paths
(``params/head/kernel``, ...), or bfloat16 bit patterns as uint16 arrays
where the model casts the leaf to bf16 before use (RRDB ``SRNet``'s
trunk), plus the model's hyper-parameters as scalars (``features`` and
``num_convs`` for the SRNetCompact family; ``features``, ``growth`` and
``num_blocks`` for RRDB ``SRNet``; ``arch = "realesrgan_rrdbnet"``,
``num_feat``, ``num_grow_ch``, ``num_block`` and ``scale`` for
``RealESRGANx2``, whose layers carry BasicSR's state-dict names
(``conv_first``, ``body/{i}/rdb{j}/conv{k}``, ``conv_body``, ``conv_up1``,
``conv_up2``, ``conv_hr``, ``conv_last``); ``features``,
``levels`` and the trained ``max_strength`` for the deblur net;
``features`` and ``temporal_window`` for the inpaint net; ``features`` for
the saliency net and the diffusion UNet).
``params_from_flax`` turns such a tree into a PyTorch state_dict (HWIO
kernels -> OIHW, dense kernels transposed) and ``write_npz`` writes a
state_dict back in that format (the trainers' checkpoints); ``load_srnet``,
``load_deblur``, ``load_inpaint``, ``load_saliency`` and ``load_diffusion``
build the models.

The JAX module's generic names work on a module the caller built:
``init_params`` (its fresh state, drawn from an explicit generator),
``load_params`` / ``maybe_load_params`` (a weights file into it, or its
fresh state when there is no file), ``host_params`` (numpy arrays) and
``default_checkpoint_dir`` (the weights directory). They read ``.npz``
weights files where the JAX package reads orbax directories: the card's
machine has no orbax.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from elvis_tpu_torch.device import resolve_device
from elvis_tpu_torch.models.deblur_unet import DeblurUNet
from elvis_tpu_torch.metrics.perceptual import PerceptualNet
from elvis_tpu_torch.models.diffusion import DiffusionRestorer, _CondUNet
from elvis_tpu_torch.models.inpaint_net import InpaintNet
from elvis_tpu_torch.models.saliency_net import SaliencyNet
from elvis_tpu_torch.models.srnet import RealESRGANx2, SRNet, SRNetCompact

__all__ = [
    "default_checkpoint_dir",
    "host_params",
    "init_params",
    "load_params",
    "maybe_load_params",
    "weights_dir",
    "weights_path",
    "params_from_flax",
    "read_npz",
    "write_npz",
    "model_meta",
    "bf16_bits_to_f32",
    "srnet_arch",
    "load_srnet",
    "load_deblur",
    "load_inpaint",
    "load_saliency",
    "load_diffusion",
]


# the ``arch`` scalar of a Real-ESRGAN RRDBNet weights file
REALESRGAN_ARCH = "realesrgan_rrdbnet"


def weights_dir() -> str:
    """The port's committed weights: ``elvis_tpu_torch/weights/``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "weights")


def weights_path(name: str) -> Optional[str]:
    """``weights/<name>.npz`` when it exists, else None."""
    path = os.path.join(weights_dir(), f"{name}.npz")
    return path if os.path.isfile(path) else None


def default_checkpoint_dir() -> str:
    """Where the port's shipped weights live: ``weights_dir()``."""
    return weights_dir()


def host_params(params: "torch.nn.Module | Mapping") -> Dict[str, np.ndarray]:
    """A module's state_dict, or a dict of tensors, as numpy arrays on the
    host (numpy arrays pass through)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {name: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for name, v in params.items()}


_ZERO_HEADS = ("tail", "eps")  # the output convs the flax models initialise at zero


def init_params(model: torch.nn.Module,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """``model``'s state as the flax models start: every kernel drawn LeCun
    normal (std ``1/sqrt(fan_in)``) from ``generator`` (default
    ``torch.Generator().manual_seed(0)``) in parameter order, every bias
    and the output head (``tail``, ``eps``) zero, buffers as they are. The
    module itself is left as it was. With the head at zero, an SR, deblur,
    inpaint or diffusion net returns its classical base."""
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    state = dict(model.state_dict())
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "bias" or (len(parts) > 1 and parts[-2] in _ZERO_HEADS):
            fresh = torch.zeros(p.shape)
        else:
            fresh = torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5
        state[name] = fresh.to(dtype=p.dtype, device=p.device)
    return state


def load_params(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """``model`` with the weights of the port weights file ``path`` (read
    by ``read_npz``; the layer names of ``params_from_flax``) loaded."""
    tree, _ = read_npz(path)
    model.load_state_dict(params_from_flax(tree))
    return model


def maybe_load_params(model: torch.nn.Module, path: Optional[str]) -> torch.nn.Module:
    """``load_params`` when ``path`` is a file, else ``model`` with its
    ``init_params`` state: a fresh SR or deblur net returns its classical
    baseline (the zero head)."""
    if path and os.path.isfile(path):
        return load_params(model, path)
    model.load_state_dict(init_params(model))
    return model


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax param tree of numpy arrays (``{'params': {...}}`` or its inner
    dict) whose layers are 2-D convs or dense layers -> a state_dict for the
    port's module of the same layer names (SRNetCompact: ``head``,
    ``conv{i}``, ``up``, ``tail``; DeblurUNet: ``enc{i}a``, ``down{i}``,
    ``up{i}``, ...). A layer that holds sub-layers (InpaintNet's gated convs:
    ``enc0/Conv_0``) becomes a dotted name (``enc0.Conv_0``). Conv kernels go
    HWIO -> OIHW, dense kernels ``(in, out)`` -> ``(out, in)``; output
    channels keep the flax order."""
    state = {}

    def walk(node: Mapping, prefix: str) -> None:
        if "kernel" not in node:
            for name, child in node.items():
                walk(child, f"{prefix}{name}.")
            return
        kernel = np.asarray(node["kernel"], np.float32)
        if kernel.ndim not in (2, 4):
            raise ValueError(f"{prefix[:-1]}: expected an HWIO conv or a dense kernel, "
                             f"got {kernel.shape}")
        order = (3, 2, 0, 1) if kernel.ndim == 4 else (1, 0)
        state[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(order)))
        state[f"{prefix}bias"] = torch.from_numpy(np.asarray(node["bias"], np.float32).copy())

    walk(tree.get("params", tree), "")
    return state


def write_npz(path: str, params: Mapping[str, torch.Tensor], meta: Mapping) -> None:
    """A state_dict of 2-D convs and dense layers (the inverse of
    ``params_from_flax``: OIHW -> HWIO, ``(out, in)`` -> ``(in, out)``,
    dotted names -> flax paths) and the model's scalar hyper-parameters
    ``meta``, written as a port weights file (float32 leaves)."""
    arrays = {}
    for name, t in params.items():
        layer, kind = name.rsplit(".", 1)
        a = t.detach().float().cpu().numpy()
        if kind == "weight":
            kind, a = "kernel", a.transpose((2, 3, 1, 0) if a.ndim == 4 else (1, 0))
        arrays["params/" + layer.replace(".", "/") + "/" + kind] = np.ascontiguousarray(a)
    for key, value in meta.items():
        arrays[key] = np.asarray(value)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def model_meta(model: torch.nn.Module) -> Dict:
    """The scalars a weights file records so the loaders rebuild ``model``."""
    if isinstance(model, RealESRGANx2):
        return {"arch": REALESRGAN_ARCH, "num_feat": model.num_feat,
                "num_grow_ch": model.num_grow_ch, "num_block": model.num_block, "scale": 2}
    if isinstance(model, SRNet):
        return {"features": model.features, "growth": model.growth,
                "num_blocks": model.num_blocks}
    if isinstance(model, SRNetCompact):
        return {"features": model.features, "num_convs": model.num_convs}
    if isinstance(model, DeblurUNet):
        return {"features": model.features, "levels": model.levels,
                "max_strength": model.max_strength}
    if isinstance(model, InpaintNet):
        return {"features": model.features, "temporal_window": model.temporal_window}
    if isinstance(model, (SaliencyNet, _CondUNet)):
        return {"features": model.features}
    if isinstance(model, PerceptualNet):  # load_perceptual reads the widths off the kernels
        return {}
    raise TypeError(f"no weights-file meta for {type(model).__name__}")


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the same values as float32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_npz(path: str):
    """``(flax tree of numpy arrays, meta dict)`` from a port weights file;
    bf16 leaves (uint16 bit patterns) come back as their float32 values."""
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
            leaf = data[key]
            node[parts[-1]] = bf16_bits_to_f32(leaf) if leaf.dtype == np.uint16 else leaf
    return tree, meta


def srnet_arch(meta: Mapping) -> tuple:
    """The architecture an SR weights file holds: ``('realesrgan', num_feat,
    num_grow_ch, num_block, scale)`` for Real-ESRGAN's RRDBNet (its meta has
    ``arch = "realesrgan_rrdbnet"``), ``('srnet', features, growth,
    num_blocks)`` for RRDB ``SRNet`` (its meta has ``num_blocks``), else
    ``('compact', features, num_convs)``."""
    if meta.get("arch") == REALESRGAN_ARCH:
        return ("realesrgan", int(meta["num_feat"]), int(meta["num_grow_ch"]),
                int(meta["num_block"]), int(meta["scale"]))
    if "num_blocks" in meta:
        return "srnet", int(meta["features"]), int(meta["growth"]), int(meta["num_blocks"])
    return "compact", int(meta["features"]), int(meta["num_convs"])


def load_srnet(path: str,
               device: "str | torch.device" = "cuda") -> "SRNet | SRNetCompact | RealESRGANx2":
    """An inference-ready SR net from a port weights file, on ``device``:
    ``RealESRGANx2`` when the file records Real-ESRGAN's RRDBNet (2x only),
    RRDB ``SRNet`` when it records ``num_blocks``, else SRNetCompact."""
    dev = resolve_device(device)
    tree, meta = read_npz(path)
    arch = srnet_arch(meta)
    if arch[0] == "realesrgan":
        if arch[4] != 2:
            raise ValueError(f"{path}: a {arch[4]}x RRDBNet; the port runs the 2x one only")
        model = RealESRGANx2(num_feat=arch[1], num_grow_ch=arch[2], num_block=arch[3])
    elif arch[0] == "srnet":
        model = SRNet(features=arch[1], growth=arch[2], num_blocks=arch[3])
    else:
        model = SRNetCompact(features=arch[1], num_convs=arch[2])
    model.load_state_dict(params_from_flax(tree))
    return model.to(dev).eval().requires_grad_(False)


def load_deblur(path: str, device: "str | torch.device" = "cuda") -> DeblurUNet:
    """An inference-ready DeblurUNet from a port weights file, on ``device``,
    conditioned with the ``max_strength`` it was trained with."""
    dev = resolve_device(device)
    tree, meta = read_npz(path)
    model = DeblurUNet(features=int(meta["features"]), levels=int(meta["levels"]),
                       max_strength=float(meta["max_strength"]))
    model.load_state_dict(params_from_flax(tree))
    return model.to(dev).eval().requires_grad_(False)


def load_inpaint(path: str, device: "str | torch.device" = "cuda") -> InpaintNet:
    """An inference-ready InpaintNet (bf16 body) from a port weights file,
    on ``device``."""
    dev = resolve_device(device)
    tree, meta = read_npz(path)
    model = InpaintNet(features=int(meta["features"]),
                       temporal_window=int(meta["temporal_window"]))
    model.load_state_dict(params_from_flax(tree))
    return model.to(dev).eval().requires_grad_(False)


def load_saliency(path: str, device: "str | torch.device" = "cuda") -> SaliencyNet:
    """An inference-ready SaliencyNet (bf16 body) from a port weights file,
    on ``device``."""
    dev = resolve_device(device)
    tree, meta = read_npz(path)
    model = SaliencyNet(features=int(meta["features"]))
    model.load_state_dict(params_from_flax(tree))
    return model.to(dev).eval().requires_grad_(False)


def load_diffusion(path: str, device: "str | torch.device" = "cuda") -> DiffusionRestorer:
    """An inference-ready DiffusionRestorer (bf16 UNet body) from a port
    weights file, on ``device``."""
    dev = resolve_device(device)
    tree, meta = read_npz(path)
    model = DiffusionRestorer(features=int(meta["features"]))
    model.unet.load_state_dict(params_from_flax(tree))
    return model.to(dev).eval().requires_grad_(False)
