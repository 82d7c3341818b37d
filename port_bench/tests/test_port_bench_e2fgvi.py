"""The ``e2fgvi_hq_1080p_inpaint`` cell on the CPU at a small size, past the
harness's look for a chip: its sound run is correct; with the timed path
broken underneath it is not: the input handed back, the learned offsets
zeroed (the flow alone), the flows zeroed, the second-order branch dropped,
attention confined to each frame's own tokens, the pooled focal tokens
dropped, the ``neural`` InpaintNet in E2FGVI's place (the path's
``FAULTS``); the fp8 control fails a limit; the control of the float32
parts moves only the holes; the seeded weights at the
``assumed`` scales, the reference's weights reader, and the FLOPs and the
deformable conv's bytes by hand.

The net is the configuration's own at every published width, all 8 blocks
and 16 deform groups, on 8 frames (two windows of ``test.py``'s loop, two
second-order steps a direction)."""

import math

import numpy as np
import pytest
import torch

from port_bench import calibrate
from port_bench.counts import e2fgvi as counts
from port_bench.harness import cell, spec
from port_bench.paths import inpaint_seeded as ps
from port_bench.reference.e2fgvi import ReferenceE2FGVI

CELL = "e2fgvi_hq_1080p_inpaint"
CONFIG = spec.config(spec.load_benchmark(), "e2fgvi_hq_1080p")
ARCH = CONFIG["arch"]
SIZE = {"height": 64, "width": 96, "segment_frames": 8}


def _run(hook=None):
    return cell.run_cell(CELL, 2**31 + 101, 0.2, False, device="cpu", overrides=SIZE,
                         driver_hook=hook)


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"]["nonhole_changed"]["value"] == 0


def _unchanged(driver):
    driver.backend = lambda f, m, b: f


def _fault(name):
    def hook(driver):
        driver.backend = ps.FAULTS[name](driver)
    hook.__name__ = name
    return hook


@pytest.mark.parametrize("fault", [_unchanged] + [_fault(name) for name in ps.FAULTS],
                         ids=lambda f: f.__name__)
def test_faults_are_not_correct(fault):
    assert not _run(fault)["correct"]


def test_control_fails_a_limit():
    driver = calibrate.make_driver(CELL, 2**31 + 77, 0.1, torch.device("cpu"), overrides=SIZE)
    limits = driver.checks["limits"]
    program, steps = calibrate.read_seed(driver, "program", 2**31 + 78, 0.1)
    assert steps >= 1 and all(program[k] <= lim for k, lim in limits.items()), program
    control, _ = calibrate.read_seed(driver, "control", 2**31 + 79, 0.1)
    assert any(control[k] > lim for k, lim in limits.items()), control
    # the second control, the float32 parts a step down (SPyNet on TF32-rounded
    # operands; the flows, offsets, mask and sampling positions in bf16): other
    # values in the holes, the same pixels outside them
    low = driver.readings(driver.control_outputs("fp32_low"))
    assert low["nonhole_changed"] == 0 and low["frame_mae_lsb"] > 0.1, low


def test_seeded_weights_follow_e2fgvi_init_at_the_assumed_scales(tmp_path):
    assumed = CONFIG["assumed"]
    layers = ps.seeded_weights(ARCH, 5, assumed)
    assert list(layers) == [name for name, _ in counts.param_shapes(ARCH)]
    w = layers["transformer.2.attn.qkv.weight"]
    assert w.shape == (1536, 512) and not layers["transformer.2.attn.qkv.bias"].any()
    assert abs(w.std() - assumed["trunk_gain"] / math.sqrt(512)) < 0.01 * w.std()
    w = layers["feat_prop_module.deform_align.forward_.conv_offset.6.weight"]
    assert w.shape == (432, 128, 3, 3)
    assert abs(w.std() - assumed["offset_head_gain"] / math.sqrt(1152)) < 0.02 * w.std()
    w = layers["feat_prop_module.deform_align.backward_.weight"]
    assert w.shape == (128, 256, 3, 3)
    assert np.abs(w).max() <= assumed["dcn_gain"] / math.sqrt(2304)
    w = layers["update_spynet.basic_module.3.basic_module.1.conv.weight"]
    assert w.shape == (64, 32, 7, 7)
    assert np.abs(w).max() <= assumed["spynet_gain"] / math.sqrt(32 * 49)
    assert layers["update_spynet.basic_module.3.basic_module.1.conv.bias"].any()
    assert np.all(layers["transformer.5.norm1.weight"] == 1)
    w = layers["sc.embedding.weight"]
    assert abs(w.std() - assumed["soft_comp_gain"] / math.sqrt(512)) < 0.01 * w.std()
    again = ps.seeded_weights(ARCH, 5, assumed)
    assert all(np.array_equal(layers[k], again[k]) for k in layers)
    path = str(tmp_path / "w.npz")
    ps.write_weights(path, layers)
    ref = ReferenceE2FGVI(path, "cpu")
    assert ref.depth == 8
    assert torch.equal(ref.p["encoder.layers.10.weight"],
                       torch.from_numpy(layers["encoder.layers.10.weight"]))
    assert torch.equal(ref.p["transformer.1.mlp.conv1.0.weight"],
                       torch.from_numpy(layers["transformer.1.mlp.conv1.0.weight"]))
    with pytest.raises(ValueError, match="no E2FGVI-HQ"):
        ReferenceE2FGVI(str(spec.ROOT / "elvis_tpu_torch/weights/inpaint.npz"), "cpu")


def test_flops_and_dcn_bytes_by_hand():
    """One forward over 8 frames at 1080x1944 (tokens 90x162, 324 windows),
    the segment's two forwards, and the deformable conv's bound."""
    h4, w4, t, px4 = 270, 486, 8, 270 * 486
    tokens, win = 90 * 162, 18 * 18
    enc = (2 * 9 * (3 * 64 + 64 * 64) * 540 * 972
           + 2 * 9 * px4 * (64 * 128 + 128 * 256 + 256 * 384 + 320 * 512 + 192 * 384
                            + 80 * 256 + 512 * 128))
    step = 2 * 9 * px4 * (388 * 128 + 128 * 128 * 2 + 128 * 432 + 256 * 128)
    prop = 2 * 7 * step + t * 2 * 9 * px4 * (256 * 128 + 128 * 128 + 384 * 128 + 128 * 128) \
        + t * 2 * px4 * 256 * 128
    keys = t * (45 + 120 + 45)
    block = (t * tokens * 2 * 512 * (1536 + 512 + 2 * 1960) + t * win * 2 * 512 * (45 + 1024)
             + win * 4 * (t * 45) * keys * 512)
    trans = t * tokens * 2 * 2 * 6272 * 512 + t * 2 * 9 * 128 * 128 * px4 + 8 * block
    dec = t * 2 * 9 * (540 * 972 * (128 * 128 + 128 * 64) + 1080 * 1944 * (64 * 64 + 64 * 3))
    spy = sum(2 * 49 * 4896 * (288 >> s) * (512 >> s) for s in range(6))
    parts = counts.forward_flops(ARCH, t, t, 1080, 1944)
    assert parts["encoder"] == t * enc and parts["propagation"] == prop
    assert parts["transformer"] == trans and parts["decoder"] == dec
    assert parts["flow"] == 2 * 7 * spy
    assert parts["dcn"] == 2 * 7 * 2 * 9 * 256 * 128 * px4
    loop = {"neighbor_stride": 5, "ref_stride": 10, "num_ref": -1}
    total = counts.segment_flops(ARCH, loop, 8, 1080, 1920)
    assert abs(total / 1e12 - 55.43) < 0.01, total / 1e12
    one = px4 * (2 * 256 + 4 * 432 + 2 * 128) + 2 * 9 * 256 * 128
    assert counts.dcn_bytes(ARCH, h4, w4) == one
    peaks = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    bound = counts.segment_dcn_bound_s(ARCH, loop, 8, 1080, 1920, peaks)
    assert bound == (2 * 5 + 2 * 7) * max(2 * 9 * 256 * 128 * px4 / 989e12, one / 3.35e12)
    assert one / 3.35e12 > 2 * 9 * 256 * 128 * px4 / 989e12  # bytes bound it
