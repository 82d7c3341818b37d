"""The 2x super-resolution nets (port of ``elvis_tpu.models.srnet``): the
SRNetCompact conv-stack family (student, compact, large), the RRDB
``SRNet``, and ``RealESRGANx2``, Real-ESRGAN's published 2x RRDBNet
(``RealESRGAN_x2plus``), which the JAX package does not have.

Public layout stays NHWC: ``(N, H, W, 3)`` float32 in [0, 255] ->
``(N, 2H, 2W, 3)``, or, for the SRNetCompact family and ``SRNet``, the
pre-interleave phase tensor ``(N, H, W, 2, 2, 3)``. Inside, the NHWC input
is viewed as NCHW with channels-last strides, the layout cuDNN's bf16
convolutions prefer.

Numerics of the SRNetCompact family and ``SRNet`` mirror the flax model:
the trunk runs in ``dtype`` (bf16 by default; flax ``nn.Conv(dtype=bf16)``
casts input, kernel and bias to bf16 and returns bf16, so the RRDB residual
sums are bf16 arithmetic too), and the 3x3 residual tail runs in float32
with TF32 off. Their output is ``clip(lanczos4_2x(x) + 127.5 * tail(...),
0, 255)``. ``RealESRGANx2`` has no Lanczos base and no phase form: its
output is the net's own, clamped as ``RealESRGANer`` does (see the class).

Each trunk conv takes its epilogue (bias, leaky ReLU, scaled residuals) as
arguments; the conv and the tail take the routes of ``kernels.routes``,
which E2FGVI-HQ shares. In bf16 inference on a card (no autograd) the conv
runs without its bias and the hand-written kernel ``kernels.conv_epilogue``
applies all of it in one in-place pass, bit-equal to the PyTorch ops it
replaces; on the CPU, in float32 and with gradients the PyTorch ops run as
written. The ``nets`` counters ``epilogue.fused`` and ``epilogue.plain``
count the trunk convs of each route, and ``modpad`` the ``RealESRGANx2``
inputs of odd height or width. The float32 tail (``_TailConv``, ``RealESRGANx2``'s
``conv_last``) takes the same rule: on a card, on the bf16 trunk output,
with autograd off, the hand-written kernel ``kernels.tail_conv`` reads the
bf16 tensor where it lies (no float32 copy, no NCHW view, no phase-domain
kernel); elsewhere the float32 convolution runs as written. Counters
``tail.fused`` and ``tail.plain`` count its calls of each route. Under
``torch.profiler`` (``utils.trace.span``) every net records ``srnet.tail``
around its tail, both RRDB nets ``srnet.body`` (the RRDB chain and its
closing conv), and ``RealESRGANx2`` also ``srnet.upsample_head`` (around
its ``srnet.tail``) and ``srnet.modpad``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.kernels.routes import float32_tail as _tail
from elvis_tpu_torch.kernels.routes import nhwc_conv as _nhwc_conv
from elvis_tpu_torch.kernels.routes import trunk_conv
from elvis_tpu_torch.kernels.tail_conv import tail_conv
from elvis_tpu_torch.ops.resize import interleave_phases, resize, upsample2x_phases
from elvis_tpu_torch.utils.trace import counter, span

__all__ = ["SRNet", "SRNetCompact", "SRNetLarge", "RealESRGANx2", "srnet_upsample_fn",
           "srnet_phase_fn"]

NETS = counter("nets")


@functools.lru_cache(maxsize=2)
def _phase_kernel_select() -> np.ndarray:
    """Constant selector ``S[ky,kx,pq,ab,dy,dx] in {0,1}`` scattering a 3x3
    full-res kernel into its phase-domain (3,3,4Cin,4Co) form: output pixel
    ``(2i+a+dy, 2j+b+dx)`` of a pixel-shuffled image lives at low-res row
    ``i + (a+dy)//2``, phase ``(a+dy)%2`` (the same for columns)."""
    s = np.zeros((3, 3, 4, 4, 3, 3), np.float32)
    for a in (0, 1):
        for b in (0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ky, p = (a + dy) // 2, (a + dy) % 2
                    kx, q = (b + dx) // 2, (b + dx) % 2
                    s[ky + 1, kx + 1, 2 * p + q, 2 * a + b, dy + 1, dx + 1] = 1.0
    return s


class _TailConv(nn.Module):
    """The float32 3x3 full-resolution residual head, with an exact
    phase-domain mode: a 3x3 conv over the pixel-shuffled image equals a
    3x3 conv over the 4Cin-channel phase tensor with a scattered kernel."""

    def __init__(self, cin: int, features: int = 3):
        super().__init__()
        self.cin, self.features = cin, features
        self.weight = nn.Parameter(torch.zeros(features, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``(N,H,W,Cin)`` -> ``(N,H,W,features)`` float32."""
        return _tail(x, self.weight, self.bias, lambda: tail_conv(x, self.weight, self.bias))

    def phase(self, x: torch.Tensor) -> torch.Tensor:
        """x ``(N,H,W,2,2,Cin)`` -> ``(N,H,W,2,2,features)`` float32."""
        return _tail(x, self.weight, self.bias, lambda: self._phase_plain(x))

    def _phase_plain(self, x: torch.Tensor) -> torch.Tensor:
        cin, co = self.cin, self.features
        n, hh, ww = x.shape[0], x.shape[1], x.shape[2]
        sel = torch.as_tensor(_phase_kernel_select(), device=x.device)
        with full_fp32():
            hwio = self.weight.permute(2, 3, 1, 0)
            k4 = torch.einsum("uvpayx,yxio->uvpiao", sel, hwio).reshape(3, 3, 4 * cin, 4 * co)
            out = _nhwc_conv(x.float().reshape(n, hh, ww, 4 * cin),
                             k4.permute(3, 2, 0, 1), None)
        return out.reshape(n, hh, ww, 2, 2, co) + self.bias


class _ConvNet(nn.Module):
    """Shared by the SR nets: trunk convs in ``dtype`` (flax
    ``nn.Conv(dtype=...)`` casts input, kernel and bias) with their
    epilogue, and the RRDB body."""

    def _conv(self, conv: nn.Conv2d, h: torch.Tensor, slope: "float | None" = None,
              residual: "torch.Tensor | None" = None, scale: float = 1.0,
              outer: "torch.Tensor | None" = None, outer_scale: float = 1.0) -> torch.Tensor:
        """``conv`` on ``h`` in ``dtype``, then ``leaky_relu(., slope)``,
        ``residual + scale * .`` and ``outer + outer_scale * .`` (each only
        where given), fused into the one kernel in bf16 inference on a card."""
        return trunk_conv(conv, h, slope, residual, scale, outer, outer_scale,
                          dtype=self.dtype)

    def _body(self, blocks, closing: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        """The RRDB chain ``blocks`` on ``h``, then ``closing`` with the long
        skip: ``h + closing(blocks(h))``."""
        with span("srnet.body"):
            skip = h
            for block in blocks:
                h = block(h, self._conv)
            return self._conv(closing, h, residual=skip)


class _Trunk(_ConvNet):
    """The nets with a phase form: the float32 tail and the Lanczos-4 base
    over ``_trunk``, which returns the up conv's ``(N,H,W,2,2,Cin)``
    pre-shuffle tensor in ``dtype``, with every activation of the flax
    model applied."""

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, phase_output: "bool | None" = None) -> torch.Tensor:
        if self.dtype == torch.float32:
            with full_fp32():
                ph = self._trunk(x)
        else:
            ph = self._trunk(x)
        if self.phase_output if phase_output is None else phase_output:
            res = self.tail.phase(ph)
            base = upsample2x_phases(x.float(), "lanczos4")
            return torch.clamp(base + 127.5 * res, 0.0, 255.0)
        base = resize(x, (x.shape[-3] * 2, x.shape[-2] * 2), method="lanczos4")
        residual = self.tail(interleave_phases(ph))
        return torch.clamp(base.float() + 127.5 * residual, 0.0, 255.0)


class DenseBlock(nn.Module):
    """Growth convs over the running concatenation, then a fuse conv back
    to ``features``: ``x + 0.2 * fuse(cat(x, x1, ...))``, with ``x_k =
    lrelu(conv_k(cat(x, x1, ..., x_{k-1})))``. ``names`` are the convs'
    attribute names, the fuse conv last (``SRNet``: three growth convs
    ``conv0..conv2`` and ``fuse``; ESRGAN: ``conv1..conv5``)."""

    def __init__(self, features: int, growth: int,
                 names: "tuple[str, ...]" = ("conv0", "conv1", "conv2", "fuse")):
        super().__init__()
        *self.growth_names, self.fuse_name = names
        for i, name in enumerate(self.growth_names):
            setattr(self, name, nn.Conv2d(features + i * growth, growth, 3, padding=1))
        setattr(self, self.fuse_name,
                nn.Conv2d(features + len(self.growth_names) * growth, features, 3, padding=1))

    def forward(self, x: torch.Tensor, conv, outer: "torch.Tensor | None" = None) -> torch.Tensor:
        """With ``outer``, ``outer + 0.2 * (x + 0.2 * fuse(...))``: the
        enclosing RRDB's residual, folded into ``fuse``'s epilogue."""
        feats = [x]
        for name in self.growth_names:
            feats.append(conv(getattr(self, name), torch.cat(feats, -1), slope=0.2))
        return conv(getattr(self, self.fuse_name), torch.cat(feats, -1), residual=x, scale=0.2,
                    outer=outer, outer_scale=0.2)


class RRDB(nn.Module):
    """Dense blocks in a chain, ``x + 0.2 * db_last(...(db_first(x)))``.
    ``names`` are the dense blocks' attribute names (``SRNet``: ``db0``,
    ``db1``; ESRGAN: ``rdb1..rdb3``) and ``conv_names`` their convs'."""

    def __init__(self, features: int, growth: int, names: "tuple[str, ...]" = ("db0", "db1"),
                 conv_names: "tuple[str, ...]" = ("conv0", "conv1", "conv2", "fuse")):
        super().__init__()
        self.names = names
        for name in names:
            setattr(self, name, DenseBlock(features, growth, conv_names))

    def forward(self, x: torch.Tensor, conv) -> torch.Tensor:
        h = x
        for name in self.names[:-1]:
            h = getattr(self, name)(h, conv)
        return getattr(self, self.names[-1])(h, conv, outer=x)


class SRNet(_Trunk):
    """RRDB 2x SR: ``head``, ``num_blocks`` residual-in-residual dense
    blocks, ``body_out`` with the long skip, the ``up`` conv to ``4 *
    features`` channels and the float32 ``tail`` on the leaky-ReLU'd
    pixel shuffle. Layer names follow the flax tree (``rrdb{i}/db{j}/
    conv{k}``, ``rrdb{i}/db{j}/fuse``), so ``models.io.params_from_flax``
    maps it. Every trunk value, the residual sums included, is in
    ``dtype``; only the tail runs in float32."""

    def __init__(self, features: int = 128, growth: int = 128, num_blocks: int = 3,
                 dtype: torch.dtype = torch.bfloat16, phase_output: bool = False):
        super().__init__()
        self.features, self.growth, self.num_blocks = features, growth, num_blocks
        self.dtype, self.phase_output = dtype, phase_output
        self.head = nn.Conv2d(3, features, 3, padding=1)
        for i in range(num_blocks):
            setattr(self, f"rrdb{i}", RRDB(features, growth))
        self.body_out = nn.Conv2d(features, features, 3, padding=1)
        self.up = nn.Conv2d(features, 4 * features, 3, padding=1)
        self.tail = _TailConv(cin=features)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = self._conv(self.head, (x.float() / 127.5 - 1.0).to(self.dtype))
        blocks = [getattr(self, f"rrdb{i}") for i in range(self.num_blocks)]
        h = self._body(blocks, self.body_out, h)
        # leaky_relu commutes with the pixel shuffle: apply it pre-shuffle
        h = self._conv(self.up, h, slope=0.2)
        n, hh, ww, c = h.shape
        return h.reshape(n, hh, ww, 2, 2, c // 4)


class SRNetCompact(_Trunk):
    """2x SR conv stack + pixel shuffle, residual over a Lanczos-4 base.

    Parameter names follow the flax tree: ``head``, ``conv{i}``, ``up``,
    ``tail`` (see ``models.io.params_from_flax``).
    """

    def __init__(self, features: int = 128, num_convs: int = 5,
                 dtype: torch.dtype = torch.bfloat16, phase_output: bool = False):
        super().__init__()
        self.features, self.num_convs = features, num_convs
        self.dtype, self.phase_output = dtype, phase_output
        self.head = nn.Conv2d(3, features, 3, padding=1)
        for i in range(num_convs):
            setattr(self, f"conv{i}", nn.Conv2d(features, features, 3, padding=1))
        self.up = nn.Conv2d(features, 12, 3, padding=1)  # 3ch x 2x2 shuffle
        self.tail = _TailConv(cin=3)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = (x.float() / 127.5 - 1.0).to(self.dtype)
        h = self._conv(self.head, h, slope=0.2)
        for i in range(self.num_convs):
            h = self._conv(getattr(self, f"conv{i}"), h, slope=0.2)
        h = self._conv(self.up, h)
        n, hh, ww, _ = h.shape
        return h.reshape(n, hh, ww, 2, 2, 3)


def SRNetLarge() -> SRNetCompact:
    """The SRNetCompact architecture scaled to 256ch x 8 convs."""
    return SRNetCompact(features=256, num_convs=8)


def _nearest2x(h: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of an NHWC tensor, contiguous."""
    n, hh, ww, c = h.shape
    return h[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(n, 2 * hh, 2 * ww, c)


class RealESRGANx2(_ConvNet):
    """Real-ESRGAN's published 2x net, ``RealESRGAN_x2plus``: BasicSR's
    ``RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23,
    num_grow_ch=32, scale=2)`` (``basicsr/archs/rrdbnet_arch.py``;
    arXiv:2107.10833, arXiv:1809.00219), run as Real-ESRGAN's
    ``RealESRGANer`` runs it, without tiling.

    ``x / 255``, reflected at the bottom and right to an even height and
    width (``RealESRGANer``'s ``mod_pad``); ``pixel_unshuffle(2)`` to 12
    channels at half size (channel ``4c + 2a + b`` from pixel ``(2i + a,
    2j + b)``); ``conv_first``; ``num_block`` RRDBs of three dense blocks
    of four growth convs and a fuse (``body.{i}.rdb{j}.conv{1..5}``) and
    ``conv_body`` with the long skip; nearest 2x, ``conv_up1``, leaky ReLU,
    nearest 2x, ``conv_up2``, leaky ReLU, ``conv_hr``, leaky ReLU,
    ``conv_last``; the pad cropped off, clamped to [0, 1], times 255.
    Parameter names are BasicSR's state-dict names. Every conv before
    ``conv_last`` is a trunk conv in ``dtype`` (bf16 by default; Real-ESRGAN
    infers in fp16), its weights held in ``dtype`` (loading rounds them
    once, as a cast per call would), ``conv_last`` in float32 with TF32
    off."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32, num_block: int = 23,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_feat, self.num_grow_ch, self.num_block = num_feat, num_grow_ch, num_block
        self.dtype = dtype
        self.conv_first = nn.Conv2d(12, num_feat, 3, padding=1)
        self.body = nn.ModuleList(
            RRDB(num_feat, num_grow_ch, ("rdb1", "rdb2", "rdb3"),
                 ("conv1", "conv2", "conv3", "conv4", "conv5")) for _ in range(num_block))
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        # the trunk's weights are held in dtype, so that no conv call casts
        # them (two launches a conv, a third of the launches of a stage)
        self.to(dtype)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, H, W, 3)`` float in [0, 255] -> ``(N, 2H, 2W, 3)`` float32."""
        if self.dtype == torch.float32:
            with full_fp32():
                return self._forward(x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        with span("srnet.modpad"):
            x = x.float() / 255.0
            if h % 2 or w % 2:
                NETS["modpad"] += 1
                x = F.pad(x.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2), mode="reflect")
                x = x.permute(0, 2, 3, 1)
        hh, ww = x.shape[1] // 2, x.shape[2] // 2
        feat = x.reshape(n, hh, 2, ww, 2, 3).permute(0, 1, 3, 5, 2, 4).reshape(n, hh, ww, 12)
        feat = self._conv(self.conv_first, feat)
        feat = self._body(self.body, self.conv_body, feat)
        with span("srnet.upsample_head"):
            feat = self._conv(self.conv_up1, _nearest2x(feat), slope=0.2)
            feat = self._conv(self.conv_up2, _nearest2x(feat), slope=0.2)
            feat = self._conv(self.conv_hr, feat, slope=0.2)
            out = _tail(feat, self.conv_last.weight, self.conv_last.bias,
                        lambda: self._conv_last_plain(feat))
        with span("srnet.modpad"):
            return torch.clamp(out[:, :2 * h, :2 * w], 0.0, 1.0) * 255.0

    def _conv_last_plain(self, feat: torch.Tensor) -> torch.Tensor:
        with full_fp32():
            return _nhwc_conv(feat.float(), self.conv_last.weight, self.conv_last.bias)


def srnet_phase_fn(model: nn.Module):
    """(frames) -> (N,H,W,2,2,3) float32 phase tensor of ``model``."""

    def up_phase(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(frames.float(), phase_output=True)

    return up_phase


def srnet_upsample_fn(model: nn.Module):
    """Adapter: (frames) -> 2x frames, for the progressive restore loop's
    ``upsample_fn`` slot. For a net with a phase form (not
    ``RealESRGANx2``) the callable carries ``.phase_fn``, the
    pre-interleave variant the loop prefers."""
    if not isinstance(model, _Trunk):
        def up_direct(frames: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return model(frames.float())

        return up_direct

    def up(frames: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(frames.float(), phase_output=False)

    up.phase_fn = srnet_phase_fn(model)
    return up
