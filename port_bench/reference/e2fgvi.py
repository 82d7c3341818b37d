"""Plain float32 reference of E2FGVI-HQ (arXiv:2204.02663;
github.com/MCG-NKU/E2FGVI: ``model/e2fgvi_hq.py``, ``model/modules/
flow_comp.py``, ``feat_prop.py``, ``tfocal_transformer_hq.py``) and of
``test.py``'s inference loop, read from a port weights file with this
file's own code and written from upstream's equations in upstream's NCHW
layout: no part of the port.

- SPyNet: ImageNet-normalised inputs resized to multiples of 32, a 6-level
  average-pooled pyramid, per level ``flow = up + basic(cat(ref,
  warp(supp, up), up))`` (border padding), resized back and rescaled;
- the encoder's nine convs with the grouped concatenation of the fourth's
  output; the propagation's second-order deformable alignment, its
  modulated deformable conv written out as a per-tap bilinear gather
  (mmcv's ``dmcn_im2col_bilinear``, zero outside the frame, nothing beyond
  one pixel of it) and a product per tap;
- the soft split as ``unfold`` and ``Linear``; each block's attention with
  the four rolled copies of the keys and values, the rolled windows' tokens
  outside the window (``valid_ind_rolled``), the pooled tokens unfolded 5x9
  around each window with -100 added where the unfold pads, and an
  explicit ``softmax(q k^T / sqrt(128) + mask) v``; the feed-forward's fold
  and unfold; the soft composition as ``Linear`` and ``fold``;
- the decoder (bilinear 2x, corners aligned), tanh;
- ``test.py``: frames ``2 x / 255 - 1``, holes zeroed, mirror-padded to
  multiples of 60x108; local windows of ``neighbor_stride`` around every
  ``neighbor_stride``-th frame plus the reference frames; the prediction
  cropped, ``(p + 1) / 2 * 255`` truncated to uint8, composited into the
  frame; ``0.5 old + 0.5 new`` where windows overlap; truncated to uint8.

Everything in float32 with TF32 off, computed in chunks of frames and
windows. ``precision="fp8"`` is the control: the input and the weight of
every convolution and linear layer the configuration runs in bf16 (all but
SPyNet's, the decoder's last and the attention products) and the deformable
conv's sampled columns rounded to float8 e4m3 with one scale per tensor (the
step below bf16), the rest as above. ``precision="fp32_low"`` is the
control of the parts the configuration keeps in float32 with TF32 off, each
a step down and the rest as above: SPyNet's convs on TF32-rounded inputs and
weights, and the flows, the deformable conv's offsets, mask and sampling
positions rounded to bf16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import to_fp8, to_tf32

ARCH = "e2fgvi_hq"
WINDOW, EXPAND, FOCAL = (5, 9), (2, 4), (5, 9)
HEADS = 4
T2T = {"kernel_size": (7, 7), "stride": (3, 3), "padding": (3, 3)}
MOD = (60, 108)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_WINDOW_CHUNK = 36  # windows per attention product


def read_weights(path: str, device) -> tuple:
    """``(meta, {state-dict name: float32 tensor})``: ``params/<path>/kernel``
    (HWIO convs -> OIHW, ``(in, out)`` linears -> ``(out, in)``) and
    ``/scale`` (LayerNorm) become ``<path>.weight``, ``/bias`` ``<path>.bias``."""
    meta, state = {}, {}
    with np.load(path) as data:
        for key in data.files:
            if "/" not in key:
                meta[key] = data[key].item()
                continue
            _, *layer, leaf = key.split("/")
            a = data[key].astype(np.float32)
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = ".".join(layer) + (".bias" if leaf == "bias" else ".weight")
            state[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return meta, state


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """``flow_comp.py``'s ``flow_warp``: ``x`` NCHW, ``flow`` ``(n, h, w, 2)``."""
    _, _, h, w = x.shape
    grid_y, grid_x = torch.meshgrid(torch.arange(0, h, device=x.device),
                                    torch.arange(0, w, device=x.device), indexing="ij")
    grid = torch.stack((grid_x, grid_y), 2).float()
    grid_flow = grid + flow
    gx = 2.0 * grid_flow[:, :, :, 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * grid_flow[:, :, :, 1] / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack((gx, gy), dim=3), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True)


def _window_partition(x: torch.Tensor, ws: tuple) -> torch.Tensor:
    b, t, h, w, c = x.shape
    x = x.view(b, t, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 2, 4, 1, 3, 5, 6).contiguous().view(-1, t * ws[0] * ws[1], c)


def _rolled_valid() -> torch.Tensor:
    """``valid_ind_rolled``: positions of the four rolled windows whose
    token lies outside the window."""
    eh, ew = EXPAND
    tl = torch.ones(WINDOW)
    tl[:-eh, :-ew] = 0
    tr = torch.ones(WINDOW)
    tr[:-eh, ew:] = 0
    bl = torch.ones(WINDOW)
    bl[eh:, :-ew] = 0
    br = torch.ones(WINDOW)
    br[eh:, ew:] = 0
    return torch.stack((tl, tr, bl, br), 0).flatten(0).nonzero(as_tuple=False).view(-1)


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor, groups: int, low=None,
                coords=None) -> torch.Tensor:
    """Modulated deformable 3x3 conv, stride 1, padding 1: a bilinear gather
    and a product per tap. ``x`` ``(1, C, H, W)``, ``offset`` ``(1, 18 G, H,
    W)`` (tap ``k`` of group ``g``: row at ``18 g + 2 k``, column at
    ``+1``), ``mask`` ``(1, 9 G, H, W)``, ``weight`` ``(Co, C, 3, 3)``.
    ``low``, where given, rounds the weight and each tap's columns;
    ``coords`` the sampling positions."""
    if low is not None:
        weight = low(weight)
    _, c, h, w = x.shape
    cg = c // groups
    src = x[0].reshape(groups, cg, h * w)
    off = offset[0].view(groups, 9, 2, h, w)
    m = mask[0].view(groups, 9, h, w)
    ys = torch.arange(h, device=x.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=x.device, dtype=torch.float32).view(1, 1, w)
    out = bias.view(-1, 1).expand(-1, h * w).clone()
    for k in range(9):
        ky, kx = divmod(k, 3)
        py = ys + (ky - 1) + off[:, k, 0]
        px = xs + (kx - 1) + off[:, k, 1]
        if coords is not None:
            py, px = coords(py), coords(px)
        inside = (py > -1) & (px > -1) & (py < h) & (px < w)
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = py - y0, px - x0
        y0, x0 = y0.long(), x0.long()
        val = torch.zeros((groups, cg, h, w), device=x.device)
        for dy, dx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                           (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yy, xx = y0 + dy, x0 + dx
            ok = inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).view(groups, 1, h * w)
            got = torch.gather(src, 2, idx.expand(-1, cg, -1)).view(groups, cg, h, w)
            val = val + (wt * ok)[:, None] * got
        col = (val * m[:, k, None]).reshape(c, h * w)
        if low is not None:
            col = low(col)
        out = out + weight[:, :, ky, kx] @ col
    return out.view(1, -1, h, w)


class ReferenceE2FGVI:
    def __init__(self, path: str, device, precision: str = "fp32"):
        self.meta, self.p = read_weights(path, device)
        if self.meta.get("arch") != ARCH:
            raise ValueError(f"{path} holds no E2FGVI-HQ generator: {self.meta}")
        self.device = torch.device(device)
        self.precision = precision
        self.valid_rolled = _rolled_valid().to(self.device)
        self.depth = sum(1 for k in self.p if k.startswith("transformer.")
                         and k.endswith(".norm1.weight"))

    # --- layers ---------------------------------------------------------
    def _low(self, x: torch.Tensor, w: torch.Tensor, name: str) -> tuple:
        spynet = name.startswith("update_spynet.")
        if self.precision == "fp8" and not (spynet or name.startswith("decoder.6")):
            return to_fp8(x), to_fp8(w)
        if self.precision == "fp32_low" and spynet:
            return to_tf32(x), to_tf32(w)
        return x, w

    def _float_part(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of a part kept in float32, a step down in ``fp32_low``."""
        return _to_bf16(x) if self.precision == "fp32_low" else x

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, padding: int = 1,
             groups: int = 1) -> torch.Tensor:
        x, w = self._low(x, self.p[name + ".weight"], name)
        return F.conv2d(x, w, self.p[name + ".bias"], stride, padding, 1, groups)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x, w = self._low(x, self.p[name + ".weight"], name)
        return F.linear(x, w, self.p[name + ".bias"])

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"])

    # --- SPyNet ---------------------------------------------------------
    def _basic(self, level: int, x: torch.Tensor) -> torch.Tensor:
        for j in range(5):
            x = self.conv(f"update_spynet.basic_module.{level}.basic_module.{j}.conv", x,
                          padding=3)
            if j < 4:
                x = F.relu(x)
        return x

    def spynet(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        h, w = ref.shape[2:4]
        w_up = w if (w % 32) == 0 else 32 * (w // 32 + 1)
        h_up = h if (h % 32) == 0 else 32 * (h // 32 + 1)
        ref = F.interpolate(ref, size=(h_up, w_up), mode="bilinear", align_corners=False)
        supp = F.interpolate(supp, size=(h_up, w_up), mode="bilinear", align_corners=False)
        mean = torch.tensor(MEAN, device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=ref.device).view(1, 3, 1, 1)
        refs, supps = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(5):
            refs.append(F.avg_pool2d(refs[-1], kernel_size=2, stride=2, count_include_pad=False))
            supps.append(F.avg_pool2d(supps[-1], kernel_size=2, stride=2,
                                      count_include_pad=False))
        refs, supps = refs[::-1], supps[::-1]
        flow = refs[0].new_zeros(ref.shape[0], 2, h_up // 32, w_up // 32)
        for level in range(len(refs)):
            if level == 0:
                flow_up = flow
            else:
                flow_up = F.interpolate(flow, scale_factor=2, mode="bilinear",
                                        align_corners=True) * 2.0
            flow = flow_up + self._basic(level, torch.cat([
                refs[level],
                flow_warp(supps[level], flow_up.permute(0, 2, 3, 1), padding_mode="border"),
                flow_up], 1))
        flow = F.interpolate(flow, size=(h, w), mode="bilinear", align_corners=False)
        flow[:, 0, :, :] *= float(w) / float(w_up)
        flow[:, 1, :, :] *= float(h) / float(h_up)
        return flow

    # --- encoder and propagation ---------------------------------------
    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        group = [1, 2, 4, 8, 1]
        spec = {0: (2, 1), 4: (2, 1), 10: (1, 2), 12: (1, 4), 14: (1, 8)}
        bt = x.shape[0]
        out, x0, h, w = x, None, 0, 0
        for i in range(0, 18, 2):
            if i == 8:
                x0 = out
                _, _, h, w = x0.size()
            if i > 8:
                g = group[(i - 8) // 2]
                out = torch.cat([x0.view(bt, g, -1, h, w), out.view(bt, g, -1, h, w)],
                                2).view(bt, -1, h, w)
            stride, groups = spec.get(i, (1, 1))
            out = F.leaky_relu(self.conv(f"encoder.layers.{i}", out, stride, 1, groups), 0.2)
        return out

    def deform_conv(self, name: str, x: torch.Tensor, offset: torch.Tensor,
                    mask: torch.Tensor, groups: int) -> torch.Tensor:
        low = to_fp8 if self.precision == "fp8" else None
        coords = _to_bf16 if self.precision == "fp32_low" else None
        return deform_conv(x, self._float_part(offset), self._float_part(mask),
                           self.p[name + ".weight"], self.p[name + ".bias"], groups, low, coords)

    def align(self, name: str, x, extra, flow_1, flow_2):
        pre = f"feat_prop_module.deform_align.{name}"
        h = torch.cat([extra, flow_1, flow_2], 1)
        for i in (0, 2, 4):
            h = F.leaky_relu(self.conv(f"{pre}.conv_offset.{i}", h), 0.1)
        out = self.conv(f"{pre}.conv_offset.6", h)
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = 10 * torch.tanh(torch.cat((o1, o2), dim=1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
        offset_1 = offset_1 + flow_1.flip(1).repeat(1, offset_1.size(1) // 2, 1, 1)
        offset_2 = offset_2 + flow_2.flip(1).repeat(1, offset_2.size(1) // 2, 1, 1)
        offset = torch.cat([offset_1, offset_2], dim=1)
        return self.deform_conv(pre, x, offset, torch.sigmoid(mask), 16)

    def propagation(self, x: torch.Tensor, flows_backward: torch.Tensor,
                    flows_forward: torch.Tensor) -> torch.Tensor:
        """``feat_prop.py``'s ``BidirectionalPropagation``: ``x`` ``(t, c,
        h, w)``, flows ``(t - 1, 2, h, w)``."""
        t, c, h, w = x.shape
        feats = {"spatial": [x[i:i + 1] for i in range(t)]}
        for module in ("backward_", "forward_"):
            feats[module] = []
            frame_idx = range(0, t)
            flow_idx = range(-1, t - 1)
            if module == "backward_":
                frame_idx = frame_idx[::-1]
                flow_idx = frame_idx
                flows = flows_backward
            else:
                flows = flows_forward
            feat_prop = x.new_zeros(1, c, h, w)
            for i, idx in enumerate(frame_idx):
                feat_current = feats["spatial"][idx]
                if i > 0:
                    flow_n1 = flows[flow_idx[i]:flow_idx[i] + 1]
                    cond_n1 = flow_warp(feat_prop, flow_n1.permute(0, 2, 3, 1))
                    feat_n2 = torch.zeros_like(feat_prop)
                    flow_n2 = torch.zeros_like(flow_n1)
                    cond_n2 = torch.zeros_like(cond_n1)
                    if i > 1:
                        feat_n2 = feats[module][-2]
                        flow_n2 = flows[flow_idx[i - 1]:flow_idx[i - 1] + 1]
                        flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1.permute(0, 2, 3, 1))
                        cond_n2 = flow_warp(feat_n2, flow_n2.permute(0, 2, 3, 1))
                    cond = torch.cat([cond_n1, feat_current, cond_n2], dim=1)
                    feat_prop = self.align(module, torch.cat([feat_prop, feat_n2], dim=1), cond,
                                           flow_n1, flow_n2)
                feat = [feat_current] + [feats[k][idx] for k in feats
                                         if k not in ("spatial", module)] + [feat_prop]
                pre = f"feat_prop_module.backbone.{module}"
                hh = F.leaky_relu(self.conv(f"{pre}.0", torch.cat(feat, dim=1)), 0.1)
                feat_prop = feat_prop + self.conv(f"{pre}.2", hh)
                feats[module].append(feat_prop)
            if module == "backward_":
                feats[module] = feats[module][::-1]
        outputs = [self.conv("feat_prop_module.fusion",
                             torch.cat([feats[k][i] for k in feats if k != "spatial"], 1),
                             padding=0) for i in range(t)]
        return torch.cat(outputs) + x

    # --- transformer ----------------------------------------------------
    def soft_split(self, x: torch.Tensor) -> torch.Tensor:
        """``(t, 128, h, w)`` -> ``(1, t, h', w', 512)``, a frame at a time."""
        h, w = x.shape[2:]
        fh = (h + 2 * 3 - 6 - 1) // 3 + 1
        fw = (w + 2 * 3 - 6 - 1) // 3 + 1
        out = [self.linear("ss.embedding", F.unfold(x[i:i + 1], **T2T).permute(0, 2, 1))
               for i in range(x.shape[0])]
        return torch.cat(out).view(1, -1, fh, fw, out[0].shape[-1])

    def soft_comp(self, x: torch.Tensor, output_size: tuple) -> torch.Tensor:
        t = x.shape[1]
        out = []
        for i in range(t):
            feat = self.linear("sc.embedding", x[0, i].reshape(1, -1, x.shape[-1]))
            feat = F.fold(feat.permute(0, 2, 1), output_size=output_size, **T2T)
            out.append(self.conv("sc.bias_conv", feat))
        return torch.cat(out)

    def pool(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """``(1, T, H, W, C)`` -> ``(1, nWh, nWw, T, C)``."""
        b, t, h, w, c = x.shape
        win = x.view(b, t, h // WINDOW[0], WINDOW[0], w // WINDOW[1], WINDOW[1], c)
        win = win.permute(0, 2, 4, 1, 3, 5, 6).contiguous()
        win = win.view(b, h // WINDOW[0], w // WINDOW[1], t, WINDOW[0] * WINDOW[1], c)
        return self.linear(f"transformer.{i}.pool_layers.0", win.transpose(4, 5)).flatten(-2)

    def attention(self, i: int, x: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        """``WindowAttention``: ``x`` ``(1, T, H, W, C)``, ``pooled`` ``(1,
        nWh, nWw, T, C)`` -> ``(1, T, H, W, C)``."""
        name = f"transformer.{i}.attn"
        b, t, nh, nw, c = x.shape
        hd = c // HEADS
        area = WINDOW[0] * WINDOW[1]
        qkv = self.linear(f"{name}.qkv", x).reshape(b, t, nh, nw, 3, c).permute(
            4, 0, 1, 2, 3, 5).contiguous()
        q, k, v = qkv[0], qkv[1], qkv[2]

        def windows(z):
            return _window_partition(z, WINDOW).view(-1, t, area, HEADS, hd)

        qw, kw, vw = (windows(z).permute(0, 3, 1, 2, 4).contiguous().view(-1, HEADS, t * area, hd)
                      for z in (q, k, v))
        eh, ew = EXPAND
        shifts = ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))

        def rolled(z, own):
            r = torch.cat([windows(torch.roll(z, shifts=s, dims=(2, 3))) for s in shifts], 2)
            r = r.permute(0, 3, 1, 2, 4).contiguous()[:, :, :, self.valid_rolled]
            return torch.cat((own, r.reshape(r.shape[0], HEADS, -1, hd)), 2)

        k_all, v_all = rolled(k, kw), rolled(v, vw)
        # pooled windows, unfolded 5x9 around each window
        xp = pooled.permute(0, 3, 1, 2, 4).contiguous()  # (1, T, nWh, nWw, C)
        n_wh, n_ww = xp.shape[2:4]
        kernel = FOCAL
        padding = (FOCAL[0] // 2, FOCAL[1] // 2)
        ones = xp.new_ones(t, 1, n_wh, n_ww)
        fmask = F.unfold(ones, kernel, padding=padding).view(
            1, t, kernel[0], kernel[1], -1).permute(4, 1, 2, 3, 0).reshape(n_wh * n_ww, -1)
        fmask = torch.where(fmask > 0, 0.0, -100.0)
        kvp = self.linear(f"{name}.qkv", xp).view(b, t, n_wh, n_ww, 3, c).permute(
            4, 0, 1, 5, 2, 3).reshape(3, -1, c, n_wh, n_ww)

        def unfolded(z):
            u = F.unfold(z, kernel, padding=padding).view(b, t, c, kernel[0], kernel[1], -1)
            u = u.permute(0, 5, 1, 3, 4, 2).contiguous().view(-1, t, kernel[0] * kernel[1],
                                                               HEADS, hd)
            return u.permute(0, 3, 1, 2, 4).contiguous().view(-1, HEADS, t * area, hd)

        k_all = torch.cat([k_all, unfolded(kvp[1])], 2)
        v_all = torch.cat([v_all, unfolded(kvp[2])], 2)
        n_local = k_all.shape[2] - t * area
        out = []
        for s in range(0, qw.shape[0], _WINDOW_CHUNK):
            e = s + _WINDOW_CHUNK
            attn = (qw[s:e] * hd ** -0.5) @ k_all[s:e].transpose(-2, -1)
            attn[..., n_local:] = attn[..., n_local:] + fmask[s:e, None, None, :]
            out.append(torch.softmax(attn, dim=-1) @ v_all[s:e])
        y = torch.cat(out).transpose(1, 2).reshape(-1, t * area, c)
        y = self.linear(f"{name}.proj", y).view(-1, t, WINDOW[0], WINDOW[1], c)
        y = y.view(b, nh // WINDOW[0], nw // WINDOW[1], t, WINDOW[0], WINDOW[1], c)
        return y.permute(0, 3, 1, 4, 2, 5, 6).contiguous().view(b, t, nh, nw, c)

    def feed_forward(self, i: int, x: torch.Tensor, output_size: tuple) -> torch.Tensor:
        """``FusionFeedForward`` on ``(1, T*H*W, C)``, a frame at a time."""
        name = f"transformer.{i}.mlp"
        t = x.shape[0]
        out = []
        for f in range(t):
            y = self.linear(f"{name}.conv1.0", x[f:f + 1])
            _, n, c = y.shape
            normalizer = F.fold(y.new_ones(1, n, 49).permute(0, 2, 1), output_size=output_size,
                                **T2T)
            y = F.fold(y.permute(0, 2, 1), output_size=output_size, **T2T)
            y = F.unfold(y / normalizer, **T2T).permute(0, 2, 1).contiguous().view(1, n, c)
            out.append(self.linear(f"{name}.conv2.1", F.gelu(y)))
        return torch.cat(out)

    def block(self, i: int, x: torch.Tensor, output_size: tuple) -> torch.Tensor:
        b, t, h, w, c = x.shape
        shortcut = x
        xn = self.layer_norm(f"transformer.{i}.norm1", x)
        x = shortcut + self.attention(i, xn, self.pool(i, xn))
        y = self.layer_norm(f"transformer.{i}.norm2", x)
        return x + self.feed_forward(i, y.view(t, h * w, c), output_size).view(b, t, h, w, c)

    # --- the generator and test.py --------------------------------------
    def decoder(self, x: torch.Tensor) -> torch.Tensor:
        up = dict(scale_factor=2, mode="bilinear", align_corners=True)
        x = F.leaky_relu(self.conv("decoder.0.conv", F.interpolate(x, **up)), 0.2)
        x = F.leaky_relu(self.conv("decoder.2", x), 0.2)
        x = F.leaky_relu(self.conv("decoder.4.conv", F.interpolate(x, **up)), 0.2)
        return torch.tanh(self.conv("decoder.6", x))

    def generator(self, masked: torch.Tensor, l_t: int) -> torch.Tensor:
        """``InpaintGenerator.forward`` for one video: ``(t, 3, H, W)`` in
        [-1, 1] -> ``(t, 3, H, W)``."""
        t, c, h, w = masked.shape
        local = F.interpolate((masked[:l_t] + 1) / 2, scale_factor=1 / 4, mode="bilinear",
                              align_corners=True, recompute_scale_factor=True)
        if l_t > 1:
            flows_forward = self._float_part(self.spynet(local[:-1], local[1:]))
            flows_backward = self._float_part(self.spynet(local[1:], local[:-1]))
        else:
            flows_forward = flows_backward = local.new_zeros(0, 2, h // 4, w // 4)
        enc = torch.cat([self.encoder(masked[i:i + 1]) for i in range(t)])
        fold_size = tuple(enc.shape[2:])
        local_feat = self.propagation(enc[:l_t], flows_forward, flows_backward)
        enc = torch.cat((local_feat, enc[l_t:]), dim=0)
        tokens = self.soft_split(enc)
        for i in range(self.depth):
            tokens = self.block(i, tokens, fold_size)
        enc = enc + self.soft_comp(tokens, fold_size)
        return torch.cat([self.decoder(enc[i:i + 1]) for i in range(t)])

    def _no_tf32(self, fn, *args):
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                return fn(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def forward_frames(self, masked: torch.Tensor, l_t: int) -> torch.Tensor:
        """``generator`` with TF32 off and autograd off."""
        return self._no_tf32(self.generator, masked, l_t)

    def inpaint(self, frames: torch.Tensor, hole: torch.Tensor, neighbor_stride: int = 5,
                ref_stride: int = 10, num_ref: int = -1) -> torch.Tensor:
        """``test.py``: uint8 ``frames`` ``(N, H, W, 3)``, bool ``hole``
        ``(N, H, W)`` -> uint8 ``(N, H, W, 3)``."""
        n, h, w, _ = frames.shape
        imgs = frames.to(self.device).permute(0, 3, 1, 2).float() / 255.0 * 2 - 1
        masks = hole.to(self.device)[:, None].float()
        binary = hole.to(self.device)[..., None].to(torch.uint8)
        source = frames.to(self.device).to(torch.uint8)
        comp = [None] * n
        for f in range(0, n, neighbor_stride):
            neighbor_ids = list(range(max(0, f - neighbor_stride),
                                      min(n, f + neighbor_stride + 1)))
            ref_ids = self.ref_index(f, neighbor_ids, n, ref_stride, num_ref)
            ids = neighbor_ids + ref_ids
            masked = imgs[ids] * (1 - masks[ids])
            h_pad, w_pad = (MOD[0] - h % MOD[0]) % MOD[0], (MOD[1] - w % MOD[1]) % MOD[1]
            masked = torch.cat([masked, torch.flip(masked, [2])], 2)[:, :, :h + h_pad, :]
            masked = torch.cat([masked, torch.flip(masked, [3])], 3)[:, :, :, :w + w_pad]
            pred = self.forward_frames(masked, len(neighbor_ids))[:, :, :h, :w]
            pred = ((pred + 1) / 2).permute(0, 2, 3, 1) * 255
            for i, idx in enumerate(neighbor_ids):
                img = pred[i].to(torch.uint8) * binary[idx] + source[idx] * (1 - binary[idx])
                if comp[idx] is None:
                    comp[idx] = img
                else:
                    comp[idx] = comp[idx].float() * 0.5 + img.float() * 0.5
        return torch.stack([c.to(torch.uint8) for c in comp])

    @staticmethod
    def ref_index(f: int, neighbor_ids: list, length: int, ref_stride: int,
                   num_ref: int) -> list:
        ref_index = []
        if num_ref == -1:
            for i in range(0, length, ref_stride):
                if i not in neighbor_ids:
                    ref_index.append(i)
        else:
            start_idx = max(0, f - ref_stride * (num_ref // 2))
            end_idx = min(length, f + ref_stride * (num_ref // 2))
            for i in range(start_idx, end_idx + 1, ref_stride):
                if i not in neighbor_ids:
                    if len(ref_index) > num_ref:
                        break
                    ref_index.append(i)
        return ref_index
