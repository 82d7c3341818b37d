"""The client's restore through an SR tier that ships no weights: the
``restore`` path with the configuration's seeded weights.

Set-up draws the weights of the configuration's ``arch`` from its
``weights_seed`` (BasicSR's initialisation, with the scales it lists under
``assumed``), writes them as a port weights file in a temporary directory,
and resolves the tier through ``resolve_sr_backend(name,
ElvisConfig(srnet_params_path=file), device)``; the reference reads the
same file with its own code. Inputs, the closed loop and the check are the
``restore`` path's.
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np
import torch

from port_bench.counts import realesrgan as counts
from port_bench.paths import restore
from port_bench.reference.realesrgan import ReferenceRealESRGAN


def seeded_weights(arch: dict, seed: int, assumed: dict) -> dict:
    """``{name: (weight OIHW, bias)}`` float32 arrays as BasicSR starts
    RRDBNet, drawn in layer order from one generator: Kaiming normal with
    zero bias in the dense blocks (``default_init_weights``, at
    ``assumed["dense_block_init_scale"]`` in place of its 0.1), PyTorch's
    conv init (uniform within ``1/sqrt(fan_in)``) elsewhere; then
    ``conv_last``'s weight times ``assumed["conv_last_weight_scale"]`` and
    its bias set to ``assumed["conv_last_bias"]``."""
    gen = torch.Generator().manual_seed(int(seed) % (2**63))
    dense = float(assumed["dense_block_init_scale"])
    out = {}
    for name, cout, cin in counts.layer_shapes(arch):
        fan_in = 9 * cin
        if name.startswith("body."):
            w = torch.randn(cout, cin, 3, 3, generator=gen) * (dense * math.sqrt(2.0 / fan_in))
            b = torch.zeros(cout)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            w = (2 * torch.rand(cout, cin, 3, 3, generator=gen) - 1) * bound
            b = (2 * torch.rand(cout, generator=gen) - 1) * bound
        out[name] = (w.numpy(), b.numpy())
    w, b = out["conv_last"]
    out["conv_last"] = (w * float(assumed["conv_last_weight_scale"]),
                        np.full_like(b, float(assumed["conv_last_bias"])))
    return out


def write_weights(path: str, arch: dict, layers: dict) -> None:
    """A port weights file: ``params/<layer path>/kernel`` (HWIO) and
    ``/bias`` float32, and the meta scalars of Real-ESRGAN's RRDBNet."""
    arrays = {"arch": np.asarray("realesrgan_rrdbnet"), "scale": np.asarray(2)}
    for key in ("num_feat", "num_grow_ch", "num_block"):
        arrays[key] = np.asarray(int(arch[key]))
    for name, (w, b) in layers.items():
        prefix = "params/" + name.replace(".", "/")
        arrays[prefix + "/kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0), np.float32)
        arrays[prefix + "/bias"] = np.asarray(b, np.float32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


class Driver(restore.Driver):
    name = "restore_seeded"

    def setup(self) -> None:
        from elvis_tpu_torch.pipeline import ElvisConfig
        from elvis_tpu_torch.restore.backends import resolve_sr_backend

        cfg = self.run.config
        self._tmp = tempfile.TemporaryDirectory(prefix="port_bench_weights_")
        self.weights = os.path.join(self._tmp.name, f"{cfg['sr_tier']}.npz")
        write_weights(self.weights, cfg["arch"],
                      seeded_weights(cfg["arch"], cfg["weights_seed"], cfg["assumed"]))
        self.backend, prov = resolve_sr_backend(
            cfg["sr_backend"], ElvisConfig(srnet_params_path=self.weights), device=self.dev)
        if f"[{cfg['sr_tier']}:" not in prov:
            raise RuntimeError(f"{cfg['sr_backend']!r} resolved to {prov}, "
                               f"not the {cfg['sr_tier']} tier")
        self.make_inputs(self.run.seed)
        self.backend(self.frames[0], self.levels[0], self.block)
        restore.sync(self.dev)

    def counts(self) -> dict:
        cfg, (n, h, w) = self.run.config, self.shape
        max_level = int(self.levels.max())
        return {
            "flops_per_step": counts.segment_flops(cfg["arch"], n, h, w, max_level),
            "conv_bound_s_per_step": counts.segment_conv_bound_s(cfg["arch"], n, h, w, max_level,
                                                                 self.run.peaks()),
        }

    def reference(self, precision: str = "fp32") -> ReferenceRealESRGAN:
        return ReferenceRealESRGAN(self.weights, self.dev, precision)
