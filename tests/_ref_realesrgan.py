"""Plain float32 reference of Real-ESRGAN's 2x RRDBNet (``RealESRGAN_x2plus``)
for the CPU tests, written from BasicSR's equations
(``basicsr/archs/rrdbnet_arch.py``) and ``RealESRGANer``'s pre- and
post-processing (github.com/xinntao/Real-ESRGAN ``realesrgan/utils.py``):
plain ``torch`` with TF32 off, importing nothing of either package.

Departures: NHWC frames in [0, 255] in and out (``RealESRGANer`` takes BGR
uint8 images and rounds its output); no tiling and no pre-pad (both 0 by
default in ``inference_realesrgan.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _lrelu(t):
    return F.leaky_relu(t, 0.2)


class ReferenceRealESRGAN:
    """``net(x)``: float ``(N, H, W, 3)`` in [0, 255] -> float32 ``(N, 2H, 2W, 3)``."""

    def __init__(self, state: dict, num_block: int):
        self.state = {k: v.float() for k, v in state.items()}
        self.num_block = num_block

    def conv(self, name, x):
        return F.conv2d(x, self.state[f"{name}.weight"], self.state[f"{name}.bias"], padding=1)

    def rdb(self, prefix, x):
        x1 = _lrelu(self.conv(f"{prefix}.conv1", x))
        x2 = _lrelu(self.conv(f"{prefix}.conv2", torch.cat((x, x1), 1)))
        x3 = _lrelu(self.conv(f"{prefix}.conv3", torch.cat((x, x1, x2), 1)))
        x4 = _lrelu(self.conv(f"{prefix}.conv4", torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv(f"{prefix}.conv5", torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x

    def rrdb(self, i, x):
        out = self.rdb(f"body.{i}.rdb3", self.rdb(f"body.{i}.rdb2", self.rdb(f"body.{i}.rdb1", x)))
        return out * 0.2 + x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                img = x.float().permute(0, 3, 1, 2) / 255.0
                h, w = img.shape[-2:]
                img = F.pad(img, (0, w % 2, 0, h % 2), mode="reflect")  # mod_pad
                b, c, hh, ww = img.shape  # pixel_unshuffle(img, 2)
                feat = img.view(b, c, hh // 2, 2, ww // 2, 2).permute(0, 1, 3, 5, 2, 4)
                feat = self.conv("conv_first", feat.reshape(b, 4 * c, hh // 2, ww // 2))
                body = feat
                for i in range(self.num_block):
                    body = self.rrdb(i, body)
                feat = feat + self.conv("conv_body", body)
                feat = _lrelu(self.conv("conv_up1", F.interpolate(feat, scale_factor=2,
                                                                  mode="nearest")))
                feat = _lrelu(self.conv("conv_up2", F.interpolate(feat, scale_factor=2,
                                                                  mode="nearest")))
                out = self.conv("conv_last", _lrelu(self.conv("conv_hr", feat)))
                out = out[:, :, :2 * h, :2 * w].clamp(0.0, 1.0) * 255.0
                return out.permute(0, 2, 3, 1)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
