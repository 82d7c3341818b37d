"""Parameters, operations and bytes of E2FGVI-HQ's generator, from the
configuration's widths (``arch``), each layer at the resolution it runs at,
and of ``test.py``'s windows over a segment.

A forward over ``t`` frames (``local`` of them the local window) at a
padded ``H x W`` runs:

- SPyNet on ``2 (local - 1)`` frame pairs at ``H/4 x W/4`` rounded up to
  multiples of 32: per pair, at each of the 6 levels, five 7x7 convs;
- per frame, the encoder's nine 3x3 convs (the first at ``H/2``, the rest
  at ``H/4``; grouped convs count ``cin / groups`` inputs an output);
- per direction, per local frame the backbone pair, and per step after the
  first the offset stack (four 3x3 convs) and the deformable conv's GEMM
  (``2 * 9 * 256 * 128`` an output pixel); per local frame the 1x1 fusion;
- per frame, the soft split (a 7x7 stride-3 conv, ``2 * 6272 * 512`` a
  token), per block and token the qkv, proj and feed-forward linears, per
  pooled token the pool (``2 * 45`` a channel) and its key and value
  linears, per window and head the two attention products over ``45 t``
  queries and ``210 t`` keys; the soft composition (``2 * 512 * 6272`` a
  token) and its 3x3 bias conv;
- per frame, the decoder's convs at ``H/2`` (two) and ``H`` (two).

A multiply-add is 2 operations; the elementwise work (activations,
normalisations, warps, folds, softmax) is not counted. The deformable
conv's least bytes: its features in (bf16), its offsets and mask in
(float32), its output out (bf16), and its weight once.

The convolutions' least time (``segment_conv_bound_s``, what
``conv_roofline.restore`` divides by the time under ``aten::convolution``)
takes every convolution the generator runs, the deformable conv's GEMM
aside, as one call per layer over the frames it runs on at once: SPyNet's
(float32) over every pair of a forward, the recurrence's offset stack and
backbone pair a frame at a time, the rest over all frames; the soft split
and soft composition as the strided and transposed convs they are; the
decoder's last conv (the float32 tail, bf16 in, float32 out) included, as
the SR nets' counts include theirs.
"""

from __future__ import annotations

import math

from port_bench.reference.e2fgvi import ReferenceE2FGVI


def _t2t(n: int, arch: dict) -> int:
    k, s, p = arch["patch"], arch["stride"], arch["padding"]
    return (n + 2 * p - k) // s + 1


def encoder_convs(arch: dict) -> list:
    """``[(cin, cout, stride, groups)]`` of the encoder's nine convs."""
    return [tuple(c) for c in arch["encoder"]]


def param_shapes(arch: dict) -> list:
    """``[(state-dict name, shape)]`` of every parameter, in one fixed
    order: encoder, decoder, propagation, soft split, soft composition,
    transformer blocks, SPyNet."""
    c = arch["channel"] // 2
    hid, ffn = arch["hidden"], arch["ffn_hidden"]
    k2 = arch["patch"] ** 2
    area = arch["window"][0] * arch["window"][1]
    groups = arch["deform_groups"]
    out = []

    def conv(name, cin, cout, k=3, g=1):
        out.extend([(f"{name}.weight", (cout, cin // g, k, k)), (f"{name}.bias", (cout,))])

    def linear(name, cin, cout):
        out.extend([(f"{name}.weight", (cout, cin)), (f"{name}.bias", (cout,))])

    for i, (cin, cout, _, g) in enumerate(encoder_convs(arch)):
        conv(f"encoder.layers.{2 * i}", cin, cout, g=g)
    conv("decoder.0.conv", c, 128)
    conv("decoder.2", 128, 64)
    conv("decoder.4.conv", 64, 64)
    conv("decoder.6", 64, 3)
    for i, d in enumerate(("backward_", "forward_")):
        pre = f"feat_prop_module.deform_align.{d}"
        out.extend([(f"{pre}.weight", (c, 2 * c, 3, 3)), (f"{pre}.bias", (c,))])
        conv(f"{pre}.conv_offset.0", 3 * c + 4, c)
        conv(f"{pre}.conv_offset.2", c, c)
        conv(f"{pre}.conv_offset.4", c, c)
        conv(f"{pre}.conv_offset.6", c, 27 * groups)
        conv(f"feat_prop_module.backbone.{d}.0", (2 + i) * c, c)
        conv(f"feat_prop_module.backbone.{d}.2", c, c)
    conv("feat_prop_module.fusion", 2 * c, c, k=1)
    linear("ss.embedding", k2 * c, hid)
    linear("sc.embedding", hid, k2 * c)
    conv("sc.bias_conv", c, c)
    for b in range(arch["depth"]):
        pre = f"transformer.{b}"
        linear(f"{pre}.pool_layers.0", area, 1)
        out.extend([(f"{pre}.norm1.weight", (hid,)), (f"{pre}.norm1.bias", (hid,))])
        linear(f"{pre}.attn.qkv", hid, 3 * hid)
        linear(f"{pre}.attn.proj", hid, hid)
        out.extend([(f"{pre}.norm2.weight", (hid,)), (f"{pre}.norm2.bias", (hid,))])
        linear(f"{pre}.mlp.conv1.0", hid, ffn)
        linear(f"{pre}.mlp.conv2.1", ffn, hid)
    widths = arch["spynet_widths"]
    for level in range(arch["spynet_levels"]):
        for j in range(len(widths) - 1):
            conv(f"update_spynet.basic_module.{level}.basic_module.{j}.conv", widths[j],
                 widths[j + 1], k=7)
    return out


def spynet_flops(arch: dict, h: int, w: int) -> float:
    """One SPyNet call on one pair at ``h x w`` (the quarter-size frames)."""
    hu, wu = 32 * math.ceil(h / 32), 32 * math.ceil(w / 32)
    widths = arch["spynet_widths"]
    per_px = sum(2 * 49 * widths[j] * widths[j + 1] for j in range(len(widths) - 1))
    levels = arch["spynet_levels"]
    return float(sum(per_px * (hu >> s) * (wu >> s) for s in range(levels)))


def dcn_flops(arch: dict, h: int, w: int) -> float:
    """One deformable conv's GEMM at ``h x w``."""
    c = arch["channel"] // 2
    return 2.0 * 9 * 2 * c * c * h * w


def dcn_bytes(arch: dict, h: int, w: int) -> float:
    """One deformable conv's least bytes: bf16 features in, float32 offsets
    and mask in, bf16 output out, the bf16 weight once."""
    c, groups = arch["channel"] // 2, arch["deform_groups"]
    return float(h * w * (2 * c * 2 + 27 * groups * 4 + c * 2) + 9 * 2 * c * c * 2)


def forward_flops(arch: dict, t: int, local: int, height: int, width: int) -> dict:
    """FLOPs of one forward by part: ``flow``, ``encoder``, ``propagation``
    (the deformable GEMMs included), ``dcn`` (those GEMMs alone),
    ``transformer``, ``attention`` (the products alone) and ``decoder``."""
    c, hid, ffn = arch["channel"] // 2, arch["hidden"], arch["ffn_hidden"]
    h4, w4 = height // 4, width // 4
    px4 = h4 * w4
    th, tw = _t2t(h4, arch), _t2t(w4, arch)
    tokens = th * tw
    wh, ww = arch["window"]
    windows = (th // wh) * (tw // ww)
    k2 = arch["patch"] ** 2
    enc = 0.0
    for i, (cin, cout, stride, g) in enumerate(encoder_convs(arch)):
        px = (height // 2) * (width // 2) if i < 2 else px4
        enc += 2 * 9 * (cin // g) * cout * px
    offset_stack = 2 * 9 * px4 * ((3 * c + 4) * c + 2 * c * c + c * 27 * arch["deform_groups"])
    steps = max(local - 1, 0)
    dcn = 2 * steps * dcn_flops(arch, h4, w4)
    prop = (2 * steps * offset_stack + dcn
            + local * 2 * 9 * px4 * ((2 * c) * c + c * c)  # backward backbone
            + local * 2 * 9 * px4 * ((3 * c) * c + c * c)  # forward backbone
            + local * 2 * px4 * 2 * c * c)  # fusion
    keys = t * (wh * ww + 4 * (wh * ww - (wh - arch["expand"][0]) * (ww - arch["expand"][1]))
                + wh * ww)
    attention = arch["depth"] * windows * 2 * 2 * (t * wh * ww) * keys * hid
    per_block = (t * tokens * 2 * hid * (3 * hid + hid + 2 * ffn)
                 + t * windows * 2 * hid * (wh * ww + 2 * hid))
    transformer = (t * tokens * 2 * k2 * c * hid * 2 + t * 2 * 9 * c * c * px4
                   + arch["depth"] * per_block + attention)
    dec = t * 2 * 9 * ((height // 2) * (width // 2) * (c * 128 + 128 * 64)
                       + height * width * (64 * 64 + 64 * 3))
    flow = 2 * steps * spynet_flops(arch, h4, w4)
    return {"flow": flow, "encoder": t * enc, "propagation": prop, "dcn": dcn,
            "transformer": transformer, "attention": attention, "decoder": dec}


def padded(height: int, width: int, arch: dict) -> tuple:
    mh, mw = arch["mod_size"]
    return height + (-height % mh), width + (-width % mw)


def windows(frames: int, neighbor_stride: int, ref_stride: int, num_ref: int) -> list:
    """``test.py``'s forwards over a segment: ``[(frames, local frames)]``."""
    out = []
    for f in range(0, frames, neighbor_stride):
        nb = list(range(max(0, f - neighbor_stride), min(frames, f + neighbor_stride + 1)))
        refs = ReferenceE2FGVI.ref_index(f, nb, frames, ref_stride, num_ref)
        out.append((len(nb) + len(refs), len(nb)))
    return out


def segment_flops(arch: dict, loop: dict, frames: int, height: int, width: int) -> float:
    hp, wp = padded(height, width, arch)
    return float(sum(sum(v for k, v in forward_flops(arch, t, lt, hp, wp).items()
                         if k not in ("dcn", "attention"))
                     for t, lt in windows(frames, loop["neighbor_stride"], loop["ref_stride"],
                                          loop["num_ref"])))


def segment_dcn_bound_s(arch: dict, loop: dict, frames: int, height: int, width: int,
                        peaks: dict) -> float:
    """The least time of a segment's deformable convs: per call, the larger
    of its FLOPs over the bf16 peak and its least bytes over the bandwidth."""
    hp, wp = padded(height, width, arch)
    h4, w4 = hp // 4, wp // 4
    calls = sum(2 * max(lt - 1, 0) for _, lt in windows(
        frames, loop["neighbor_stride"], loop["ref_stride"], loop["num_ref"]))
    one = max(dcn_flops(arch, h4, w4) / peaks["bf16_flops"],
              dcn_bytes(arch, h4, w4) / peaks["hbm_bytes_per_s"])
    return calls * one


def conv_calls(arch: dict, t: int, local: int, height: int, width: int) -> list:
    """``[(flops, bytes, peak)]`` of every convolution call of one forward
    over ``t`` frames (``local`` of them local) at a padded ``height x
    width``: ``bytes`` its input and output activations once and its weight
    once, ``peak`` ``"bf16_flops"`` or ``"fp32_flops"``."""
    c, hid, groups = arch["channel"] // 2, arch["hidden"], arch["deform_groups"]
    k2 = arch["patch"] ** 2
    h2, w2, h4, w4 = height // 2, width // 2, height // 4, width // 4
    px4, tokens = h4 * w4, _t2t(h4, arch) * _t2t(w4, arch)
    calls = []

    def call(cin, cout, taps, in_px, out_px, n, nbytes=2, out_bytes=None, peak="bf16_flops",
             transposed=False):
        out_bytes = out_bytes or nbytes
        calls.append((2.0 * taps * cin * cout * (in_px if transposed else out_px) * n,
                      float(n * (cin * in_px * nbytes + cout * out_px * out_bytes)
                            + taps * cin * cout * nbytes), peak))

    steps = max(local - 1, 0)
    if steps:
        hu, wu = 32 * math.ceil(h4 / 32), 32 * math.ceil(w4 / 32)
        widths = arch["spynet_widths"]
        for s in range(arch["spynet_levels"]):
            px = (hu >> s) * (wu >> s)
            for j in range(len(widths) - 1):
                call(widths[j], widths[j + 1], 49, px, px, 2 * steps, 4, peak="fp32_flops")
    in_px = height * width
    for i, (cin, cout, stride, g) in enumerate(encoder_convs(arch)):
        out_px = h2 * w2 if i < 2 else px4
        calls.append((2.0 * 9 * (cin // g) * cout * out_px * t,
                      float(t * (cin * in_px + cout * out_px) * 2 + 9 * (cin // g) * cout * 2),
                      "bf16_flops"))
        in_px = out_px
    for _ in range(steps * 2):  # the offset stack, a step a direction
        for cin, cout in ((3 * c + 4, c), (c, c), (c, c), (c, 27 * groups)):
            call(cin, cout, 9, px4, px4, 1)
    for i in range(2):  # the backbone pair, a frame a direction
        for _ in range(local):
            call((2 + i) * c, c, 9, px4, px4, 1)
            call(c, c, 9, px4, px4, 1)
    if local:
        call(2 * c, c, 1, px4, px4, local)  # fusion
    call(c, hid, k2, px4, tokens, t)  # soft split: a 7x7 stride-3 conv
    call(hid, c, k2, tokens, px4, t, transposed=True)  # soft composition
    call(1, c, k2, tokens, px4, 1, 4, peak="fp32_flops", transposed=True)  # its bias's fold
    call(c, c, 9, px4, px4, t)  # its bias conv
    call(c, 128, 9, h2 * w2, h2 * w2, t)
    call(128, 64, 9, h2 * w2, h2 * w2, t)
    call(64, 64, 9, height * width, height * width, t)
    call(64, 3, 9, height * width, height * width, t, 2, 4, peak="fp32_flops")  # the tail
    return calls


def segment_conv_bound_s(arch: dict, loop: dict, frames: int, height: int, width: int,
                         peaks: dict) -> float:
    """The least time of a segment's convolutions: per call, the larger of
    its FLOPs over the peak of its type and its bytes over the bandwidth."""
    hp, wp = padded(height, width, arch)
    return sum(max(flops / peaks[peak], moved / peaks["hbm_bytes_per_s"])
               for t, lt in windows(frames, loop["neighbor_stride"], loop["ref_stride"],
                                    loop["num_ref"])
               for flops, moved, peak in conv_calls(arch, t, lt, hp, wp))
