"""E2FGVI-HQ, the flow-guided video inpainter of "Towards An End-to-End
Framework for Flow-Guided Video Inpainting" (arXiv:2204.02663, CVPR 2022),
at its published widths, under the state-dict names of
github.com/MCG-NKU/E2FGVI (``model/e2fgvi_hq.py``, ``model/modules/
flow_comp.py``, ``feat_prop.py``, ``tfocal_transformer_hq.py``), and
``test.py``'s inference loop (``inpaint_video``), which the JAX package
does not have.

``E2FGVIHQ(frames, num_local)``: ``(T, H, W, 3)`` masked frames in [-1, 1]
(holes at 0, ``H`` and ``W`` multiples of 60 and 108), the first
``num_local`` of them the local window -> ``(T, H, W, 3)`` float32 in
[-1, 1]:

- **flow** (``update_spynet``): SPyNet (6 levels of five 7x7 convs, 8 -> 32
  -> 64 -> 32 -> 16 -> 2, ReLU between; ImageNet-normalised inputs padded
  to multiples of 32) on the local frames in [0, 1] at a quarter size
  (bilinear, corners aligned), both ways between neighbours;
- **encoder**: nine 3x3 convs with leaky ReLU 0.2: 3 -> 64 (stride 2), 64,
  128 (stride 2), 256, 384, then 640 -> 512 (2 groups), 768 -> 384 (4), 640
  -> 256 (8), 512 -> 128, each of the last four reading the 256-channel
  output of the fourth conv concatenated in group by group;
- **propagation** (``feat_prop_module``): backward, then forward, over the
  local frames; each step after the first aligns the previous two
  propagated features with a ``SecondOrderDeformableAlignment`` (a
  modulated deformable 3x3 conv 256 -> 128 of 16 deform groups, its offsets
  ``10 tanh(.)`` plus the flipped flow and its mask ``sigmoid(.)`` from a
  388 -> 128 -> 128 -> 128 -> 432 conv stack, leaky ReLU 0.1, over the
  warped features, the current one and both flows), then a backbone conv
  pair (leaky ReLU 0.1) adds to it; a 1x1 conv fuses the two directions
  over a residual. The second-order flow is ``f1 + warp(f2, f1)``;
- **transformer**: a soft split (7x7 patches, stride 3, padding 3, then
  ``Linear(6272, 512)``), eight ``TemporalFocalTransformerBlock``s and a
  soft composition (``Linear(512, 6272)``, fold, a 3x3 bias conv) added to
  the features. A block is ``x + attn(norm1(x))``, then ``x +
  mlp(norm2(x))``. Attention is 512 wide with 4 heads over windows of 5x9
  tokens and every frame of the forward; a window's keys are its own
  tokens, its neighbours under the four rolls by (+-2, +-4) at the
  positions outside the window (the rolls wrap around the frame), and the
  window-pooled tokens (``Linear(45, 1)`` over each window) of the 5x9
  windows around it, -100 added where that neighbourhood leaves the grid.
  The feed-forward is ``Linear(512, 1960)``, a fold and unfold of 7x7
  patches normalised by the fold of ones, GELU, ``Linear(1960, 512)``;
- **decoder**: bilinear 2x (corners aligned) and a 3x3 conv 128 -> 128,
  a conv to 64, bilinear 2x and a conv 64 -> 64, each with leaky ReLU 0.2,
  a conv to 3, tanh.

Departures from upstream, which runs float32 throughout:

- precision: the convs, the deformable conv's GEMM, the transformer's
  linears and its attention in ``dtype`` (bf16 by default, weights held in
  it); float32 for SPyNet and the flows, the deformable conv's offsets,
  mask, sampling positions and bilinear weights, the flow warps, the
  LayerNorms and the token stream they normalise, the fold normaliser, the
  decoder's last conv (the SR nets' float32 tail: on a card the
  ``tail_conv`` kernel reads the bf16 features in place), the tanh, and
  ``inpaint_video``'s composite; TF32 off wherever float32 is used;
- the soft split runs as the 7x7 stride-3 convolution it is (the linear's
  weight viewed as its kernel) and the soft composition as the transposed
  convolution it is, plus the fold of the linear's bias; the same sums in
  another order;
- the rolled and pooled keys are gathered with one index table per frame
  size rather than four rolls and an unfold; the same keys and masks;
- the feed-forward's fold and unfold run in float32 on the bf16 linear's
  output; on a card, in bf16 inference, the fold, its normalisation, the
  unfold, GELU and the cast back run as one kernel (``kernels.ffn_fold``),
  bit-equal to the float32 ops they replace, and fc2 reads its contiguous
  output.

The convs take the SR nets' routes (``kernels.routes``): every conv of the
encoder, propagation, soft composition and decoder but the last goes
through the trunk convs' epilogue (bias, leaky ReLU, residual; the
``conv_epilogue`` kernel in bf16 inference on a card, counters
``nets.epilogue.fused`` / ``.plain``), the decoder's last through the
float32 tail (the ``tail_conv`` kernel, counters ``nets.tail.fused`` /
``.plain``, span ``srnet.tail``); the deformable conv goes through
``kernels.dcn`` (the hand-written sampling kernel on a card). Under
``torch.profiler`` the forward records ``e2fgvi.flow``,
``e2fgvi.encoder``, ``e2fgvi.propagation`` (with ``e2fgvi.dcn`` around
each deformable conv), ``e2fgvi.transformer`` (with ``e2fgvi.attention``
around each block's windows, pooling, keys and attention, and
``e2fgvi.ffn`` around each block's feed-forward: fc1, the fold and fc2)
and ``e2fgvi.decoder``; the ``nets`` counters ``e2fgvi.forwards``,
``e2fgvi.frames`` and ``dcn.calls`` count every call, ``ffn.fused`` and
``ffn.plain`` each feed-forward by its route.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elvis_tpu_torch.device import full_fp32
from elvis_tpu_torch.kernels.dcn import modulated_deform_conv
from elvis_tpu_torch.kernels.ffn_fold import ffn_fold_gelu, ffn_fold_gelu_cuda
from elvis_tpu_torch.kernels.routes import float32_tail, trunk_conv
from elvis_tpu_torch.kernels.tail_conv import tail_conv
from elvis_tpu_torch.utils.trace import counter, span

__all__ = ["E2FGVIHQ", "dilate_hole", "inpaint_video", "mirror_pad", "reference_ids",
           "MOD_SIZE"]

NETS = counter("nets")
MOD_SIZE = (60, 108)  # test.py pads frames to multiples of these
CHANNEL, HIDDEN, HEADS, DEPTH = 256, 512, 4, 8
DEFORM_GROUPS = 16
WINDOW = (5, 9)
EXPAND = (2, 4)  # tuple(i // 2 for i in WINDOW)
PATCH, STRIDE, PAD = 7, 3, 3  # the soft split's unfold
FFN_HIDDEN = 1960
POOL_MASK = -100.0
_SPY_MEAN = (0.485, 0.456, 0.406)
_SPY_STD = (0.229, 0.224, 0.225)


def _tail(conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    """The decoder's float32 conv to 3 channels (the SR nets' tail route)."""
    return float32_tail(h, conv.weight, conv.bias,
                        lambda: tail_conv(h, conv.weight, conv.bias))


def _up2(h: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x of an NHWC tensor, corners aligned."""
    out = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """``x`` ``(N, H, W, C)`` sampled at each pixel plus ``flow`` ``(N, H, W,
    2)`` (x, y), bilinear with corners aligned, in float32; returned in
    ``x``'s dtype."""
    n, h, w, _ = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device, dtype=torch.float32),
                            torch.arange(w, device=x.device, dtype=torch.float32), indexing="ij")
    fx = 2.0 * (gx + flow[..., 0]) / max(w - 1, 1) - 1.0
    fy = 2.0 * (gy + flow[..., 1]) / max(h - 1, 1) - 1.0
    out = F.grid_sample(x.permute(0, 3, 1, 2).float(), torch.stack((fx, fy), dim=3),
                        mode="bilinear", padding_mode=padding_mode, align_corners=True)
    return out.permute(0, 2, 3, 1).to(x.dtype)


class _ConvModule(nn.Module):
    """mmcv's ``ConvModule`` as SPyNet uses it: a 7x7 conv, ReLU or none."""

    def __init__(self, cin: int, cout: int, relu: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 7, 1, 3)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x) if self.relu else x


class _SPyNetBasicModule(nn.Module):
    def __init__(self):
        super().__init__()
        widths = (8, 32, 64, 32, 16, 2)
        self.basic_module = nn.Sequential(*[
            _ConvModule(widths[i], widths[i + 1], relu=i < 4) for i in range(5)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.basic_module(x)


class SPyNet(nn.Module):
    """SPyNet (arXiv:1611.00850) as E2FGVI's ``flow_comp.py`` runs it,
    float32, NCHW: ``spynet(ref, supp)`` is the flow ``(N, 2, H, W)`` (x,
    y) at ``ref`` that warps ``supp`` onto it."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(_SPyNetBasicModule() for _ in range(6))

    def _compute_flow(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        n, _, h, w = ref.shape
        mean = torch.tensor(_SPY_MEAN, device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor(_SPY_STD, device=ref.device).view(1, 3, 1, 1)
        ref, supp = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(5):
            ref.append(F.avg_pool2d(ref[-1], 2, 2, count_include_pad=False))
            supp.append(F.avg_pool2d(supp[-1], 2, 2, count_include_pad=False))
        ref, supp = ref[::-1], supp[::-1]
        flow = ref[0].new_zeros(n, 2, h // 32, w // 32)
        for level in range(len(ref)):
            if level == 0:
                up = flow
            else:
                up = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2.0
            warped = flow_warp(supp[level].permute(0, 2, 3, 1), up.permute(0, 2, 3, 1),
                               padding_mode="border").permute(0, 3, 1, 2)
            flow = up + self.basic_module[level](torch.cat([ref[level], warped, up], 1))
        return flow

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        h, w = ref.shape[2:4]
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        ref = F.interpolate(ref, size=(h_up, w_up), mode="bilinear", align_corners=False)
        supp = F.interpolate(supp, size=(h_up, w_up), mode="bilinear", align_corners=False)
        flow = F.interpolate(self._compute_flow(ref, supp), size=(h, w), mode="bilinear",
                             align_corners=False)
        scale = torch.tensor([w / w_up, h / h_up], device=flow.device).view(1, 2, 1, 1)
        return flow * scale


class Encoder(nn.Module):
    group = (1, 2, 4, 8, 1)

    def __init__(self):
        super().__init__()
        spec = [(3, 64, 2, 1), (64, 64, 1, 1), (64, 128, 2, 1), (128, 256, 1, 1),
                (256, 384, 1, 1), (640, 512, 1, 2), (768, 384, 1, 4), (640, 256, 1, 8),
                (512, 128, 1, 1)]
        layers = []
        for cin, cout, stride, groups in spec:
            layers += [nn.Conv2d(cin, cout, 3, stride, 1, groups=groups), nn.LeakyReLU(0.2)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(T, H, W, 3)`` -> ``(T, H/4, W/4, 128)``."""
        out, x0 = x, None
        for i in range(0, len(self.layers), 2):
            if i == 8:
                x0 = out
            if i > 8:
                g = self.group[(i - 8) // 2]
                out = torch.cat([x0.unflatten(-1, (g, -1)), out.unflatten(-1, (g, -1))],
                                -1).flatten(-2)
            out = trunk_conv(self.layers[i], out, slope=0.2)
        return out


class _Deconv(nn.Module):
    """Bilinear 2x (corners aligned), then a 3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1)


class SecondOrderDeformableAlignment(nn.Module):
    """mmcv's ``ModulatedDeformConv2d`` (``weight`` ``(128, 256, 3, 3)``,
    ``bias``) with E2FGVI's offset and mask head ``conv_offset``."""

    def __init__(self, cin: int = 2 * CHANNEL // 2, cout: int = CHANNEL // 2,
                 deform_groups: int = DEFORM_GROUPS, max_residue_magnitude: float = 10.0):
        super().__init__()
        self.deform_groups = deform_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * cout + 4, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(cout, 27 * deform_groups, 3, 1, 1))

    def forward(self, x: torch.Tensor, extra: torch.Tensor, flow_1: torch.Tensor,
                flow_2: torch.Tensor) -> torch.Tensor:
        """``x`` ``(1, H, W, 256)`` and ``extra`` ``(1, H, W, 384)`` in the
        trunk's dtype, the flows float32 ``(1, H, W, 2)`` (x, y)."""
        dt = self.weight.dtype
        h = torch.cat([extra, flow_1.to(dt), flow_2.to(dt)], -1)
        for i in (0, 2, 4):
            h = trunk_conv(self.conv_offset[i], h, slope=0.1)
        out = trunk_conv(self.conv_offset[6], h).float()
        taps = 9 * self.deform_groups
        offset = self.max_residue_magnitude * torch.tanh(out[..., :2 * taps])
        # the flow as (row, column), once for each tap of each half's groups
        flows = torch.cat([flow_1.flip(-1).repeat(1, 1, 1, taps // 2),
                           flow_2.flip(-1).repeat(1, 1, 1, taps // 2)], -1)
        offset = (offset + flows).contiguous()
        mask = torch.sigmoid(out[..., 2 * taps:]).contiguous()
        with span("e2fgvi.dcn"):
            NETS["dcn.calls"] += 1
            return modulated_deform_conv(x.contiguous(), offset, mask, self.weight, self.bias,
                                         self.deform_groups)


class BidirectionalPropagation(nn.Module):
    def __init__(self, channel: int = CHANNEL // 2):
        super().__init__()
        self.channel = channel
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(("backward_", "forward_")):
            self.deform_align[name] = SecondOrderDeformableAlignment(2 * channel, channel)
            self.backbone[name] = nn.Sequential(
                nn.Conv2d((2 + i) * channel, channel, 3, 1, 1), nn.LeakyReLU(0.1),
                nn.Conv2d(channel, channel, 3, 1, 1))
        self.fusion = nn.Conv2d(2 * channel, channel, 1, 1, 0)

    def forward(self, x: torch.Tensor, flows_backward: torch.Tensor,
                flows_forward: torch.Tensor) -> torch.Tensor:
        """``x`` ``(T, H, W, C)``; ``flows_backward[i]`` the flow at frame
        ``i`` to frame ``i + 1``, ``flows_forward[i]`` at ``i + 1`` to ``i``,
        ``(T - 1, H, W, 2)`` float32."""
        t = x.shape[0]
        spatial = [x[i:i + 1] for i in range(t)]
        feats = {}
        for name in ("backward_", "forward_"):
            frame_idx = list(range(t))
            flow_idx = list(range(-1, t - 1))
            if name == "backward_":
                frame_idx = frame_idx[::-1]
                flow_idx = frame_idx
                flows = flows_backward
            else:
                flows = flows_forward
            props = []
            feat_prop = torch.zeros_like(spatial[0])
            for i, idx in enumerate(frame_idx):
                current = spatial[idx]
                if i > 0:
                    flow_n1 = flows[flow_idx[i]:flow_idx[i] + 1]
                    cond_n1 = flow_warp(feat_prop, flow_n1)
                    feat_n2 = torch.zeros_like(feat_prop)
                    flow_n2 = torch.zeros_like(flow_n1)
                    cond_n2 = torch.zeros_like(cond_n1)
                    if i > 1:
                        feat_n2 = props[-2]
                        flow_n2 = flows[flow_idx[i - 1]:flow_idx[i - 1] + 1]
                        flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1)
                        cond_n2 = flow_warp(feat_n2, flow_n2)
                    cond = torch.cat([cond_n1, current, cond_n2], -1)
                    feat_prop = self.deform_align[name](torch.cat([feat_prop, feat_n2], -1),
                                                        cond, flow_n1, flow_n2)
                others = [feats["backward_"][idx]] if name == "forward_" else []
                h = trunk_conv(self.backbone[name][0],
                               torch.cat([current, *others, feat_prop], -1), slope=0.1)
                feat_prop = trunk_conv(self.backbone[name][2], h, residual=feat_prop)
                props.append(feat_prop)
            feats[name] = props[::-1] if name == "backward_" else props
        both = torch.cat([torch.cat(feats["backward_"]), torch.cat(feats["forward_"])], -1)
        return trunk_conv(self.fusion, both, residual=x.contiguous())


class SoftSplit(nn.Module):
    def __init__(self):
        super().__init__()
        self.embedding = nn.Linear(PATCH * PATCH * CHANNEL // 2, HIDDEN)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """``(T, h, w, 128)`` -> float32 tokens ``(T, h', w', 512)``: the
        unfold and ``embedding`` as one strided convolution."""
        weight = self.embedding.weight.view(HIDDEN, CHANNEL // 2, PATCH, PATCH)
        out = F.conv2d(feat.to(weight.dtype).permute(0, 3, 1, 2), weight, self.embedding.bias,
                       stride=STRIDE, padding=PAD)
        return out.permute(0, 2, 3, 1).float()


class SoftComp(nn.Module):
    def __init__(self):
        super().__init__()
        self.embedding = nn.Linear(HIDDEN, PATCH * PATCH * CHANNEL // 2)
        self.bias_conv = nn.Conv2d(CHANNEL // 2, CHANNEL // 2, 3, 1, 1)

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """``enc + bias_conv(fold(embedding(tokens)))``: the fold of the
        linear as one transposed convolution plus the fold of its bias."""
        t, th, tw, _ = tokens.shape
        h, w = enc.shape[1:3]
        c = CHANNEL // 2
        weight = self.embedding.weight.t().reshape(HIDDEN, c, PATCH, PATCH)
        pad_h = h - (th - 1) * STRIDE + 2 * PAD - PATCH
        pad_w = w - (tw - 1) * STRIDE + 2 * PAD - PATCH
        feat = F.conv_transpose2d(tokens.to(weight.dtype).permute(0, 3, 1, 2), weight, None,
                                  STRIDE, PAD, (pad_h, pad_w))
        ones = torch.ones((1, 1, th, tw), dtype=torch.float32, device=tokens.device)
        bias = F.conv_transpose2d(ones, self.embedding.bias.float().view(1, c, PATCH, PATCH),
                                  None, STRIDE, PAD, (pad_h, pad_w))
        feat = feat + bias.to(feat.dtype)
        return trunk_conv(self.bias_conv, feat.permute(0, 2, 3, 1),
                          residual=enc.contiguous())


@functools.lru_cache(maxsize=8)
def _key_tables(h: int, w: int, device: torch.device) -> tuple:
    """For tokens ``h x w`` (whole 5x9 windows): ``(local, pooled, bias)``.
    ``local`` ``(windows, 165)``: each window's own 45 tokens, then its rolled
    neighbours (rolls by (-2, -4), (-2, 4), (2, -4), (2, 4), wrapping, at the
    positions whose source lies outside the window), as indices into the
    ``h * w`` tokens. ``pooled`` ``(windows, 45)``: the 5x9 pooled windows
    around each window, as indices into the pooled grid padded by 2 rows and
    4 columns on each side; ``bias`` ``(windows, 45)`` 0 there, -100 where the
    index falls in the padding. On ``device``, made once per size."""
    wh, ww = WINDOW
    eh, ew = EXPAND
    nh, nw = h // wh, w // ww
    a, b = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    valid = []
    for sy, sx in ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)):
        # the position's source in the window, a - sy, b - sx, lies outside it
        out = (a - sy < 0) | (a - sy >= wh) | (b - sx < 0) | (b - sx >= ww)
        valid.append((sy, sx, a[out], b[out]))
    local, pooled, bias = [], [], []
    pad_w = nw + 2 * (ww // 2)
    for i in range(nh):
        for j in range(nw):
            rows, cols = [i * wh + a.ravel()], [j * ww + b.ravel()]
            for sy, sx, va, vb in valid:
                rows.append((i * wh + va - sy) % h)
                cols.append((j * ww + vb - sx) % w)
            local.append(np.concatenate(rows) * w + np.concatenate(cols))
            pr, pc = i + a.ravel(), j + b.ravel()  # in the padded grid
            pooled.append(pr * pad_w + pc)
            inside = (pr >= wh // 2) & (pr < nh + wh // 2) & (pc >= ww // 2) & (pc < nw + ww // 2)
            bias.append(np.where(inside, 0.0, POOL_MASK))
    return (torch.from_numpy(np.stack(local)).to(device),
            torch.from_numpy(np.stack(pooled)).to(device),
            torch.from_numpy(np.stack(bias).astype(np.float32)).to(device))


class WindowAttention(nn.Module):
    def __init__(self, dim: int = HIDDEN, num_heads: int = HEADS):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def pooled_keys(self, pooled: torch.Tensor) -> tuple:
        """``(k, v)`` of the pooled tokens ``(T, nh, nw, C)``."""
        c = pooled.shape[-1]
        kv = F.linear(pooled, self.qkv.weight[c:], self.qkv.bias[c:])
        return kv[..., :c], kv[..., c:]

    def forward(self, x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        """``x`` ``(T, h, w, C)`` normalised tokens, ``pooled`` ``(T, h/5,
        w/9, C)`` their window-pooled tokens, both in the trunk's dtype."""
        t, h, w, c = x.shape
        wh, ww = WINDOW
        nh, nw = h // wh, w // ww
        heads, hd = self.num_heads, c // self.num_heads
        local, pooled_idx, bias = _key_tables(h, w, x.device)
        q, k, v = F.linear(x, self.qkv.weight, self.qkv.bias).split(c, -1)
        kp, vp = self.pooled_keys(pooled)
        pad = (0, 0, ww // 2, ww // 2, wh // 2, wh // 2)
        n_win, n_local = local.shape

        def keys(tokens, pooled_tokens):
            # (windows, heads, T * 210, hd): the window's own and rolled
            # tokens, then the pooled ones, frame by frame
            own = tokens.reshape(t, h * w, c)[:, local]
            pool = F.pad(pooled_tokens, pad).reshape(t, -1, c)[:, pooled_idx]
            both = torch.cat([own, pool], 2)  # (T, windows, 210, C)
            return both.view(t, n_win, -1, heads, hd).permute(1, 3, 0, 2, 4).reshape(
                n_win, heads, -1, hd)

        kk, vv = keys(k, kp), keys(v, vp)
        qw = q.reshape(t, nh, wh, nw, ww, heads, hd).permute(1, 3, 5, 0, 2, 4, 6).reshape(
            n_win, heads, t * wh * ww, hd)
        mask = torch.cat([torch.zeros((n_win, n_local), device=x.device), bias], 1)
        mask = mask.repeat(1, t).to(x.dtype).view(n_win, 1, 1, -1)
        out = F.scaled_dot_product_attention(qw, kk, vv, attn_mask=mask)
        out = out.reshape(nh, nw, heads, t, wh, ww, hd).permute(3, 0, 4, 1, 5, 2, 6).reshape(
            t, h, w, c)
        return F.linear(out, self.proj.weight, self.proj.bias)


class FusionFeedForward(nn.Module):
    def __init__(self, dim: int = HIDDEN, hidden: int = FFN_HIDDEN):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Linear(dim, hidden))
        self.conv2 = nn.Sequential(nn.GELU(), nn.Linear(hidden, dim))

    def forward(self, y: torch.Tensor, output_size: tuple) -> torch.Tensor:
        """``y`` ``(T, th, tw, 512)`` -> fc2(gelu(unfold(fold(fc1(y)) /
        fold(1)))): the fold, unfold and GELU as the ``ffn_fold`` kernel on a
        bf16 CUDA tensor with autograd off, else as the plain ops."""
        t, th, tw, _ = y.shape
        fc1, fc2 = self.conv1[0], self.conv2[1]
        with span("e2fgvi.ffn"):
            h = F.linear(y, fc1.weight, fc1.bias).reshape(t, th * tw, -1)
            if h.is_cuda and h.dtype == torch.bfloat16 and not torch.is_grad_enabled():
                NETS["ffn.fused"] += 1
                h = ffn_fold_gelu_cuda(h, th, tw, output_size)
            else:
                NETS["ffn.plain"] += 1
                h = ffn_fold_gelu(h, th, tw, output_size)
            return F.linear(h, fc2.weight, fc2.bias).reshape(t, th, tw, -1)


class TemporalFocalTransformerBlock(nn.Module):
    def __init__(self, dim: int = HIDDEN, num_heads: int = HEADS):
        super().__init__()
        wh, ww = WINDOW
        self.pool_layers = nn.ModuleList([nn.Linear(wh * ww, 1)])
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = FusionFeedForward(dim)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """``(T, h, w, C)`` -> ``(T, h/5, w/9, C)``: ``pool_layers[0]`` over
        each window's 45 tokens."""
        t, h, w, c = x.shape
        wh, ww = WINDOW
        win = x.reshape(t, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 5, 2, 4)
        p = self.pool_layers[0]
        return F.linear(win.reshape(t, h // wh, w // ww, c, wh * ww), p.weight, p.bias)[..., 0]

    def forward(self, x: torch.Tensor, output_size: tuple) -> torch.Tensor:
        """``x`` float32 tokens ``(T, h, w, 512)``."""
        dt = self.attn.qkv.weight.dtype
        with span("e2fgvi.attention"):
            xn = F.layer_norm(x, x.shape[-1:], self.norm1.weight, self.norm1.bias).to(dt)
            x = x + self.attn(xn, self.pool(xn)).float()
        y = F.layer_norm(x, x.shape[-1:], self.norm2.weight, self.norm2.bias).to(dt)
        return x + self.mlp(y, output_size).float()


class E2FGVIHQ(nn.Module):
    """E2FGVI-HQ's ``InpaintGenerator`` (see the module docstring). The
    trunk's weights are held in ``dtype``; SPyNet, the LayerNorms and the
    decoder's last conv in float32."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        c = CHANNEL // 2
        self.encoder = Encoder()
        self.decoder = nn.Sequential(
            _Deconv(c, 128), nn.LeakyReLU(0.2), nn.Conv2d(128, 64, 3, 1, 1), nn.LeakyReLU(0.2),
            _Deconv(64, 64), nn.LeakyReLU(0.2), nn.Conv2d(64, 3, 3, 1, 1))
        self.feat_prop_module = BidirectionalPropagation(c)
        self.ss = SoftSplit()
        self.sc = SoftComp()
        self.transformer = nn.Sequential(*[TemporalFocalTransformerBlock() for _ in range(DEPTH)])
        self.update_spynet = SPyNet()
        self.to(dtype)
        self.update_spynet.float()
        self.decoder[6].float()
        for blk in self.transformer:
            blk.norm1.float()
            blk.norm2.float()

    def flows(self, local: torch.Tensor) -> tuple:
        """``local`` float32 ``(T, H, W, 3)`` in [0, 1] -> the flows at a
        quarter size, ``(flows_backward, flows_forward)``, each ``(T - 1,
        H/4, W/4, 2)`` float32: the first at frame ``i`` to ``i + 1``."""
        t, h, w, _ = local.shape
        small = F.interpolate(local.permute(0, 3, 1, 2), size=(h // 4, w // 4), mode="bilinear",
                              align_corners=True)
        if t < 2:
            empty = small.new_zeros((0, h // 4, w // 4, 2))
            return empty, empty
        with full_fp32():
            flow = self.update_spynet(torch.cat([small[:-1], small[1:]]),
                                      torch.cat([small[1:], small[:-1]]))
        flow = flow.permute(0, 2, 3, 1)
        return flow[:t - 1], flow[t - 1:]

    def forward(self, frames: torch.Tensor, num_local: int) -> torch.Tensor:
        if self.dtype == torch.float32:
            with full_fp32():
                return self._forward(frames, num_local)
        return self._forward(frames, num_local)

    def _forward(self, frames: torch.Tensor, num_local: int) -> torch.Tensor:
        t, h, w, _ = frames.shape
        if h % MOD_SIZE[0] or w % MOD_SIZE[1]:
            raise ValueError(f"frames of {h}x{w}: pad them to multiples of {MOD_SIZE}")
        NETS["e2fgvi.forwards"] += 1
        NETS["e2fgvi.frames"] += t
        with span("e2fgvi.flow"):
            flows_backward, flows_forward = self.flows((frames[:num_local].float() + 1) / 2)
        with span("e2fgvi.encoder"):
            enc = self.encoder(frames.to(self.dtype))
        with span("e2fgvi.propagation"):
            local = self.feat_prop_module(enc[:num_local], flows_backward, flows_forward)
            enc = torch.cat([local, enc[num_local:]]) if num_local < t else local
        with span("e2fgvi.transformer"):
            tokens = self.ss(enc)
            for blk in self.transformer:
                tokens = blk(tokens, enc.shape[1:3])
            enc = self.sc(tokens, enc)
        with span("e2fgvi.decoder"):
            d = self.decoder
            out = trunk_conv(d[0].conv, _up2(enc), slope=0.2)
            out = trunk_conv(d[2], out, slope=0.2)
            out = trunk_conv(d[4].conv, _up2(out), slope=0.2)
            return torch.tanh(_tail(d[6], out))


def mirror_pad(x: torch.Tensor, mod: tuple = MOD_SIZE) -> torch.Tensor:
    """``(T, H, W, C)`` extended by its mirror image at the bottom and right
    to multiples of ``mod`` (``test.py``: ``cat([x, flip(x)])[:H + pad]``)."""
    h, w = x.shape[1:3]
    ph, pw = -h % mod[0], -w % mod[1]
    x = torch.cat([x, torch.flip(x, [1])], 1)[:, :h + ph]
    return torch.cat([x, torch.flip(x, [2])], 2)[:, :, :w + pw]


def dilate_hole(hole: torch.Tensor, iterations: int) -> torch.Tensor:
    """``test.py``'s ``cv2.dilate`` of each mask with a 3x3 cross,
    ``iterations`` times: bool ``(N, H, W)`` grown by every pixel within
    ``iterations`` steps up, down, left or right, not past the frame."""
    if iterations <= 0:
        return hole
    m = hole[:, None].float()
    for _ in range(int(iterations)):
        m = torch.maximum(F.max_pool2d(m, (3, 1), 1, (1, 0)), F.max_pool2d(m, (1, 3), 1, (0, 1)))
    return m[:, 0] > 0


def reference_ids(f: int, neighbor_ids: list, length: int, ref_stride: int,
                  num_ref: int) -> list:
    """``test.py``'s ``get_ref_index``: every ``ref_stride``-th frame outside
    the window (``num_ref`` -1), or up to ``num_ref`` of them around ``f``."""
    refs = []
    if num_ref == -1:
        return [i for i in range(0, length, ref_stride) if i not in neighbor_ids]
    start = max(0, f - ref_stride * (num_ref // 2))
    end = min(length, f + ref_stride * (num_ref // 2))
    for i in range(start, end + 1, ref_stride):
        if i not in neighbor_ids:
            if len(refs) > num_ref:
                break
            refs.append(i)
    return refs


def inpaint_video(model: E2FGVIHQ, frames: torch.Tensor, hole: torch.Tensor,
                  neighbor_stride: int = 5, ref_stride: int = 10,
                  num_ref: int = -1) -> torch.Tensor:
    """``test.py``'s loop: uint8 ``frames`` ``(N, H, W, 3)`` (or float
    values in [0, 255]) and a bool ``hole`` ``(N, H, W)`` -> uint8 ``(N, H,
    W, 3)``. For every ``neighbor_stride``-th frame ``f``, the frames within
    ``neighbor_stride`` of it and the reference frames go through ``model``
    (inputs ``2 x / 255 - 1`` with the holes at 0, mirror-padded); each local
    frame's prediction, cropped, to [0, 255] and truncated to uint8, fills
    its holes; a frame that several windows predict keeps ``0.5 old + 0.5
    new`` in float32, truncated to uint8 at the end."""
    n = frames.shape[0]
    holef = hole[..., None].float()
    masked = mirror_pad((frames.float() / 255.0 * 2.0 - 1.0) * (1.0 - holef))
    h, w = frames.shape[1:3]
    source = frames.to(torch.uint8) if frames.dtype != torch.uint8 else frames
    comp = torch.zeros(frames.shape, dtype=torch.float32, device=frames.device)
    seen = torch.zeros(n, dtype=torch.bool)
    for f in range(0, n, neighbor_stride):
        nb = list(range(max(0, f - neighbor_stride), min(n, f + neighbor_stride + 1)))
        ids = nb + reference_ids(f, nb, n, ref_stride, num_ref)
        pred = model(masked[ids], len(nb))[:len(nb), :h, :w]
        pred = ((pred + 1) / 2 * 255).to(torch.uint8)
        img = torch.where(hole[nb, ..., None], pred, source[nb]).float()
        old = seen[nb].to(frames.device)[:, None, None, None]
        comp[nb] = torch.where(old, comp[nb] * 0.5 + img * 0.5, img)
        seen[nb] = True
    return comp.to(torch.uint8)
