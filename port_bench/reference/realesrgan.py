"""Plain float32 reference of Real-ESRGAN's 2x RRDBNet (``RealESRGAN_x2plus``:
``RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23,
num_grow_ch=32, scale=2)``), read from a port weights file with this file's
own code and written from BasicSR's equations
(``basicsr/archs/rrdbnet_arch.py``) and ``RealESRGANer``'s pre- and
post-processing (github.com/xinntao/Real-ESRGAN, ``realesrgan/utils.py``).

``(N, H, W, 3)`` float pixels in [0, 255] -> ``(N, 2H, 2W, 3)``:

- ``x / 255``, reflected at the bottom and right to an even height and
  width (``mod_pad``), ``pixel_unshuffle(2)`` (channel ``4c + 2a + b`` from
  pixel ``(2i + a, 2j + b)``), ``conv_first``;
- ``num_block`` RRDBs, ``x + 0.2 * rdb3(rdb2(rdb1(x)))``; a dense block is
  ``x + 0.2 * conv5(cat(x, x1..x4))`` with ``x_k = lrelu(conv_k(cat(x,
  x1..x_{k-1})))``, leaky ReLU 0.2; then ``feat + conv_body(body)``;
- ``lrelu(conv_up1(nearest_2x(.)))``, ``lrelu(conv_up2(nearest_2x(.)))``,
  ``conv_last(lrelu(conv_hr(.)))``; the pad cropped off, clamped to [0, 1],
  times 255.

Every convolution is 3x3 with zero padding, in float32 with TF32 off.
Departures from ``RealESRGANer``: NHWC RGB frames in [0, 255] in and out
(it takes BGR uint8 images and rounds its output to uint8, which the
progressive restore does once, at its end); no tiling or pre-pad (0 by
default); float32 where its inference runs fp16.

``precision="fp8"`` is the control: every convolution of the dense blocks
(``body.*``, 345 of the 350 bfloat16 convolutions) has its input and weight
rounded to float8 e4m3 with one scale per tensor (the step below the
configuration's bfloat16), the rest as above; so the limits it calibrates
see a fault of the body's own precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import to_fp8


def read_weights(path: str, device) -> tuple:
    """``(meta, {layer: (weight OIHW, bias)})`` with the layers under their
    BasicSR names (``body.0.rdb1.conv1``), as float32 tensors."""
    meta, leaves = {}, {}
    with np.load(path) as data:
        for key in data.files:
            if "/" not in key:
                meta[key] = data[key].item()
                continue
            _, *layer, leaf = key.split("/")  # params/<layer path>/<kernel|bias>
            leaves.setdefault(".".join(layer), {})[leaf] = data[key].astype(np.float32)
    layers = {}
    for name, leaf in leaves.items():
        w = torch.from_numpy(np.ascontiguousarray(leaf["kernel"].transpose(3, 2, 0, 1)))
        layers[name] = (w.to(device), torch.from_numpy(leaf["bias"].copy()).to(device))
    return meta, layers


def _lrelu(t: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(t, 0.2)


class ReferenceRealESRGAN:
    def __init__(self, path: str, device, precision: str = "fp32"):
        self.meta, self.layers = read_weights(path, device)
        if self.meta.get("arch") != "realesrgan_rrdbnet" or int(self.meta["scale"]) != 2:
            raise ValueError(f"{path} holds no 2x Real-ESRGAN RRDBNet: {self.meta}")
        self.num_block = int(self.meta["num_block"])
        self.precision = precision

    def _conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        w, b = self.layers[name]
        if self.precision == "fp8" and name.startswith("body."):
            h, w = to_fp8(h), to_fp8(w)
        return F.conv2d(h, w, b, padding=1)

    def _rdb(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(_lrelu(self._conv(f"{prefix}.conv{k}", torch.cat(feats, 1))))
        return x + 0.2 * self._conv(f"{prefix}.conv5", torch.cat(feats, 1))

    def _net(self, img: torch.Tensor) -> torch.Tensor:
        """NCHW in [0, 1] with an even height and width -> NCHW at 2x."""
        n, c, h, w = img.shape
        feat = img.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        feat = self._conv("conv_first", feat.reshape(n, 4 * c, h // 2, w // 2))
        body = feat
        for i in range(self.num_block):
            x = body
            for j in (1, 2, 3):
                x = self._rdb(f"body.{i}.rdb{j}", x)
            body = body + 0.2 * x
        feat = feat + self._conv("conv_body", body)
        feat = _lrelu(self._conv("conv_up1", F.interpolate(feat, scale_factor=2, mode="nearest")))
        feat = _lrelu(self._conv("conv_up2", F.interpolate(feat, scale_factor=2, mode="nearest")))
        return self._conv("conv_last", _lrelu(self._conv("conv_hr", feat)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """float ``(N, H, W, 3)`` -> float32 ``(N, 2H, 2W, 3)``."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                h, w = x.shape[1], x.shape[2]
                img = F.pad(x.float().permute(0, 3, 1, 2) / 255.0, (0, w % 2, 0, h % 2),
                            mode="reflect")
                out = self._net(img)[:, :, :2 * h, :2 * w]
                return (torch.clamp(out, 0.0, 1.0) * 255.0).permute(0, 2, 3, 1)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
