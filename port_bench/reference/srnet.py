"""Plain float32 reference of the shipped 2x SR nets, read from their
``.npz`` weights files with this file's own code.

Both nets map ``(N, H, W, 3)`` float pixels in [0, 255] to ``(N, 2H, 2W, 3)``:
``clip(lanczos4_2x(x) + 127.5 * tail(shuffle(trunk(x / 127.5 - 1))), 0, 255)``.

- SRNetCompact (the student, 256 features, 6 convs): head conv, then each
  conv followed by leaky ReLU 0.2, then an ``up`` conv to 12 channels,
  pixel-shuffled to 3 channels at 2x, with no activation.
- RRDB SRNet (ESRGAN's design, arXiv:1809.00219; 128 features, growth 128,
  3 blocks): head conv; each residual-in-residual block is two dense
  blocks, ``x + 0.2 * db1(db0(x))``; a dense block runs three growth convs
  with leaky ReLU 0.2 over the running concatenation and a ``fuse`` conv,
  ``x + 0.2 * fuse(...)``; then ``body_out`` with the long skip, the ``up``
  conv to 4x the features, leaky ReLU 0.2 and the pixel shuffle.
- The tail is a 3x3 conv at full resolution. The shuffle puts channel
  ``(a * 2 + b) * C + c`` of the low-resolution map at pixel
  ``(2i + a, 2j + b)``, channel ``c``.

Every convolution is 3x3 with zero padding, in float32 with TF32 off. The
RRDB file stores its trunk as bfloat16 bit patterns (uint16), which are
exact float32 values.

``precision="fp8"`` is the control: every trunk convolution's input and
weight rounded to float8 e4m3 with one scale per tensor (the step below the
configuration's bfloat16 trunk), the rest as above.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import to_fp8
from port_bench.reference.resize import lanczos2x


def read_weights(path: str, device) -> tuple:
    """``(meta, {layer: (weight OIHW, bias)})`` as float32 tensors."""
    meta, layers = {}, {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if "/" not in key:
                meta[key] = arr.item()
                continue
            if arr.dtype == np.uint16:  # bfloat16 bit patterns
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            _, *layer, leaf = key.split("/")
            layers.setdefault("/".join(layer), {})[leaf] = arr
    out = {}
    for name, leaves in layers.items():
        w = torch.from_numpy(np.ascontiguousarray(leaves["kernel"].transpose(3, 2, 0, 1)))
        b = torch.from_numpy(np.asarray(leaves["bias"], np.float32).copy())
        out[name] = (w.float().to(device), b.float().to(device))
    return meta, out


def _shuffle(h: torch.Tensor) -> torch.Tensor:
    """NCHW ``(N, 4C, H, W)`` -> ``(N, C, 2H, 2W)``, channel ``(2a + b) C + c``
    to pixel ``(2i + a, 2j + b)``."""
    n, c4, hh, ww = h.shape
    c = c4 // 4
    return h.reshape(n, 2, 2, c, hh, ww).permute(0, 3, 4, 1, 5, 2).reshape(n, c, 2 * hh, 2 * ww)


class ReferenceSR:
    def __init__(self, path: str, device, precision: str = "fp32"):
        self.meta, self.layers = read_weights(path, device)
        self.rrdb = "num_blocks" in self.meta
        self.precision = precision

    def _conv(self, name: str, h: torch.Tensor, trunk: bool = True) -> torch.Tensor:
        w, b = self.layers[name]
        if trunk and self.precision == "fp8":
            h, w = to_fp8(h), to_fp8(w)
        return F.conv2d(h, w, b, padding=1)

    def _trunk(self, h: torch.Tensor) -> torch.Tensor:
        lrelu = lambda t: F.leaky_relu(t, 0.2)  # noqa: E731
        if not self.rrdb:
            h = lrelu(self._conv("head", h))
            for i in range(int(self.meta["num_convs"])):
                h = lrelu(self._conv(f"conv{i}", h))
            return self._conv("up", h)
        h = self._conv("head", h)
        skip = h
        for r in range(int(self.meta["num_blocks"])):
            x = h
            for d in range(2):
                feats = [x]
                for k in range(3):
                    feats.append(lrelu(self._conv(f"rrdb{r}/db{d}/conv{k}", torch.cat(feats, 1))))
                x = x + 0.2 * self._conv(f"rrdb{r}/db{d}/fuse", torch.cat(feats, 1))
            h = h + 0.2 * x
        h = skip + self._conv("body_out", h)
        return lrelu(self._conv("up", h))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """float ``(N, H, W, 3)`` -> float32 ``(N, 2H, 2W, 3)``."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                xf = x.float()
                h = self._trunk((xf / 127.5 - 1.0).permute(0, 3, 1, 2))
                res = self._conv("tail", _shuffle(h), trunk=False)
                return torch.clamp(lanczos2x(xf) + 127.5 * res.permute(0, 2, 3, 1), 0.0, 255.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
