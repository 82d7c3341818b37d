"""Operations and bytes of Real-ESRGAN's 2x RRDBNet's convolutions, from the
configuration's widths (``arch``: ``num_feat``, ``num_grow_ch``,
``num_block``), each at the resolution it runs at.

Every conv is 3x3: ``2 * 9 * cin * cout`` FLOPs per output pixel. A stage
input of ``h x w`` is first padded to an even ``hp x wp``; ``conv_first``,
the RRDB body and ``conv_body`` run at ``hp/2 x wp/2``, ``conv_up1`` at
``hp x wp``, ``conv_up2``, ``conv_hr`` and ``conv_last`` at ``2hp x 2wp``.
Bytes count each conv's input and output activations once (bfloat16 before
``conv_last``, float32 in it) and its weights once per call.
"""

from __future__ import annotations

BODY, HEAD_1X, HEAD_2X = "body", "1x", "2x"


def layer_shapes(arch: dict) -> list:
    """``[(BasicSR name, cout, cin)]`` of every conv, in the order of the
    forward pass."""
    f, g, blocks = int(arch["num_feat"]), int(arch["num_grow_ch"]), int(arch["num_block"])
    body = [(f"body.{i}.rdb{j}.conv{k}", f if k == 5 else g, f + (k - 1) * g)
            for i in range(blocks) for j in (1, 2, 3) for k in range(1, 6)]
    head = [(name, f, f) for name in ("conv_up1", "conv_up2", "conv_hr")]
    return [("conv_first", f, 12), *body, ("conv_body", f, f), *head, ("conv_last", 3, f)]


_WHERE = {"conv_up1": HEAD_1X, "conv_up2": HEAD_2X, "conv_hr": HEAD_2X, "conv_last": HEAD_2X}


def conv_layers(arch: dict) -> list:
    """``[(cin, cout, where, bytes per element)]``, one per conv, in the
    order of the forward pass; ``where`` is ``BODY``, ``HEAD_1X`` or ``HEAD_2X``."""
    return [(cin, cout, _WHERE.get(name, BODY), 4 if name == "conv_last" else 2)
            for name, cout, cin in layer_shapes(arch)]


def conv_pixels(where: str, height: int, width: int) -> int:
    """Output pixels of a conv at ``where`` for one ``height x width`` input."""
    hp, wp = height + height % 2, width + width % 2
    return {BODY: hp * wp // 4, HEAD_1X: hp * wp, HEAD_2X: 4 * hp * wp}[where]


def stage_shapes(height: int, width: int, max_level: int) -> list:
    """The input ``(h, w)`` of each 2x stage of a progressive restore."""
    return [(height >> s, width >> s) for s in range(max_level, 0, -1)]


def segment_flops(arch: dict, frames: int, height: int, width: int, max_level: int) -> float:
    return float(sum(frames * 2 * 9 * cin * cout * conv_pixels(where, h, w)
                     for h, w in stage_shapes(height, width, max_level)
                     for cin, cout, where, _ in conv_layers(arch)))


def segment_conv_bound_s(arch: dict, frames: int, height: int, width: int, max_level: int,
                         peaks: dict) -> float:
    """The least time the convs of one segment can take: per conv call, the
    larger of its FLOPs over the peak of its type (bfloat16 before
    ``conv_last``, float32 in it) and its bytes over the bandwidth."""
    total = 0.0
    for h, w in stage_shapes(height, width, max_level):
        for cin, cout, where, nbytes in conv_layers(arch):
            pixels = frames * conv_pixels(where, h, w)
            flops = 2.0 * 9 * cin * cout * pixels
            moved = (cin + cout) * pixels * nbytes + 9 * cin * cout * nbytes
            peak = peaks["bf16_flops"] if nbytes == 2 else peaks["fp32_flops"]
            total += max(flops / peak, moved / peaks["hbm_bytes_per_s"])
    return total
