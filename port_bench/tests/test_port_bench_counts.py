"""The FLOP and byte counters against counts made by hand."""

from port_bench.counts import block_transform, srnet

STUDENT = {"kind": "compact", "features": 256, "num_convs": 6}
RRDB = {"kind": "rrdb", "features": 128, "growth": 128, "num_blocks": 3}


def test_student_flops_per_pixel_by_hand():
    head, body, up = 2 * 9 * 3 * 256, 6 * 2 * 9 * 256 * 256, 2 * 9 * 256 * 12
    tail = 4 * 2 * 9 * 3 * 3  # full resolution: four output pixels per input pixel
    assert srnet.flops_per_pixel(STUDENT) == head + body + up + tail == 7_147_656


def test_rrdb_flops_per_pixel_by_hand():
    f = g = 128
    dense = sum(2 * 9 * (f + k * g) * g for k in range(3)) + 2 * 9 * (f + 3 * g) * f
    want = 2 * 9 * 3 * f + 6 * dense + 2 * 9 * f * f + 2 * 9 * f * 4 * f + 4 * 2 * 9 * f * 3
    assert srnet.flops_per_pixel(RRDB) == want == 19_203_840


def test_segment_flops_at_1080p():
    # stage inputs 240x135, 480x270, 960x540 for 8 frames
    pixels = 8 * (240 * 135 + 480 * 270 + 960 * 540)
    assert srnet.stage_pixels(8, 1080, 1920, 3) == [8 * 240 * 135, 8 * 480 * 270, 8 * 960 * 540]
    assert srnet.segment_flops(STUDENT, 8, 1080, 1920, 3) == 7_147_656 * pixels
    assert abs(srnet.segment_flops(RRDB, 8, 1080, 1920, 3) / 1e12 - 104.53) < 0.01


def test_conv_bound_is_at_least_the_flops_bound():
    peaks = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    for arch in (STUDENT, RRDB):
        flops = srnet.segment_flops(arch, 8, 1080, 1920, 3)
        bound = srnet.segment_conv_bound_s(arch, 8, 1080, 1920, 3, peaks)
        assert bound >= flops / peaks["bf16_flops"]
        assert bound < 2 * flops / peaks["bf16_flops"]


def test_block_transform_bytes_by_hand():
    frames = 8 * 1080 * 1920 * 3
    levels = 8 * 135 * 240 * 4
    table = 4 * 8 * 8 * 4
    assert block_transform.frame_transform_bytes(8, 1080, 1920) == 2 * frames + levels + table
    # 0.0300 ms at 3.35 TB/s
    assert abs(block_transform.frame_transform_bytes(8, 1080, 1920) / 3.35e12 * 1e3 - 0.0300) < 1e-4
