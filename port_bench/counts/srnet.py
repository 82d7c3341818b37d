"""Operations and bytes of the SR nets' convolutions, from the
configuration's widths.

Every conv is 3x3: ``2 * 9 * cin * cout`` FLOPs per output pixel. The
tail runs at the 2x resolution, four output pixels per input pixel; the
rest at the stage's input resolution. Bytes count each conv's input and
output activations once (bfloat16 in the trunk, float32 in the tail) and
its weights once per call.
"""

from __future__ import annotations


def conv_layers(arch: dict) -> list:
    """``[(cin, cout, pixels per input pixel, bytes per element)]``."""
    f = int(arch["features"])
    if arch["kind"] == "compact":
        layers = [(3, f, 1, 2)] + [(f, f, 1, 2)] * int(arch["num_convs"]) + [(f, 12, 1, 2)]
        return layers + [(3, 3, 4, 4)]
    g = int(arch["growth"])
    dense = [(f + k * g, g, 1, 2) for k in range(3)] + [(f + 3 * g, f, 1, 2)]
    layers = [(3, f, 1, 2)] + dense * (2 * int(arch["num_blocks"]))
    return layers + [(f, f, 1, 2), (f, 4 * f, 1, 2), (f, 3, 4, 4)]


def flops_per_pixel(arch: dict) -> float:
    return float(sum(2 * 9 * cin * cout * px for cin, cout, px, _ in conv_layers(arch)))


def stage_pixels(frames: int, height: int, width: int, max_level: int) -> list:
    """The input pixels of each 2x stage of a progressive restore."""
    return [frames * (height >> s) * (width >> s) for s in range(max_level, 0, -1)]


def segment_flops(arch: dict, frames: int, height: int, width: int, max_level: int) -> float:
    return flops_per_pixel(arch) * sum(stage_pixels(frames, height, width, max_level))


def segment_conv_bound_s(arch: dict, frames: int, height: int, width: int, max_level: int,
                         peaks: dict) -> float:
    """The least time the convs of one segment can take: per conv call, the
    larger of its FLOPs over the peak of its type (bfloat16 trunk, float32
    tail) and its bytes over the bandwidth."""
    total = 0.0
    for pixels in stage_pixels(frames, height, width, max_level):
        for cin, cout, px, nbytes in conv_layers(arch):
            flops = 2.0 * 9 * cin * cout * px * pixels
            moved = (cin + cout) * px * pixels * nbytes + 9 * cin * cout * nbytes
            peak = peaks["bf16_flops"] if nbytes == 2 else peaks["fp32_flops"]
            total += max(flops / peak, moved / peaks["hbm_bytes_per_s"])
    return total
