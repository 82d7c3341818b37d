"""The ``realesrgan_x2plus_1080p_restore`` cell on the CPU at a small size,
past the harness's look for a chip: its sound run is correct; with the timed
path broken underneath (its input handed back, half a segment, +6 LSB on a
frame, another tier in its place, the dense blocks' growth convs zeroed,
every dense block skipped) it is not; the fp8 control of the dense blocks
fails a limit; the seeded weights, the reference and the FLOP count by hand.

The net is the configuration's own, all 23 RRDBs at every published width
on the configuration's seeded weights: what the limits see of the dense
blocks depends on their depth (two RRDBs of these weights grow their
features by about 1.5, 23 by some 70), so a shallower net would not show
whether the cell's check judges them."""

import math

import numpy as np
import pytest
import torch

from port_bench import calibrate
from port_bench.counts import realesrgan as counts
from port_bench.harness import cell, spec
from port_bench.paths.restore_seeded import seeded_weights, write_weights
from port_bench.reference.realesrgan import ReferenceRealESRGAN

from conftest import SMALL

CELL = "realesrgan_x2plus_1080p_restore"
CONFIG = spec.config(spec.load_benchmark(), "realesrgan_x2plus_1080p")
ARCH = dict(CONFIG["arch"], num_block=2)


def _run(hook=None):
    return cell.run_cell(CELL, 2**31 + 101, 0.5, False, device="cpu", overrides=SMALL,
                         driver_hook=hook)


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def _unchanged(driver):
    driver.backend = lambda f, m, b: f


def _half(driver):
    fn = driver.backend
    driver.backend = lambda f, m, b: fn(f[: f.shape[0] // 2], m[: m.shape[0] // 2], b)


def _altered(driver):
    fn = driver.backend

    def altered(f, m, b):
        out = fn(f, m, b).clone()
        out[0] = torch.clamp(out[0].int() + 6, 0, 255).to(out.dtype)
        return out

    driver.backend = altered


def _wrong_tier(driver):
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_sr_backend

    driver.backend, _ = resolve_sr_backend("realesrgan", ElvisConfig(), device=driver.dev)


def _zeroed(suffixes):
    """The tier on the configuration's weights with the dense blocks' convs
    whose names end in ``suffixes`` zeroed, weight and bias; the reference
    keeps the sound file."""
    def fault(driver):
        from elvis_tpu_torch.pipeline import ElvisConfig
        from elvis_tpu_torch.restore.backends import resolve_sr_backend

        cfg = driver.run.config
        layers = seeded_weights(cfg["arch"], cfg["weights_seed"], cfg["assumed"])
        for name, (w, b) in layers.items():
            if name.startswith("body.") and name.endswith(suffixes):
                layers[name] = (np.zeros_like(w), np.zeros_like(b))
        path = driver.weights[:-len(".npz")] + "_fault.npz"
        write_weights(path, cfg["arch"], layers)
        driver.backend, _ = resolve_sr_backend(cfg["sr_backend"],
                                               ElvisConfig(srnet_params_path=path), driver.dev)
    return fault


# x_k = lrelu(0) = 0 for every growth conv: each dense block reads x alone
_growth_zeroed = _zeroed(("conv1", "conv2", "conv3", "conv4"))
# x + 0.2 * conv5(...) = x: every dense block skipped, each RRDB 1.2 x
_dense_blocks_skipped = _zeroed(("conv5",))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, _wrong_tier, _growth_zeroed,
                                   _dense_blocks_skipped])
def test_faults_are_not_correct(fault):
    assert not _run(fault)["correct"]


def test_control_fails_a_limit():
    size = dict(SMALL, height=72, width=104, segment_frames=8)
    driver = calibrate.make_driver(CELL, 2**31 + 77, 0.2, torch.device("cpu"), overrides=size)
    limits = driver.checks["limits"]
    program, steps = calibrate.read_seed(driver, "program", 2**31 + 78, 0.2)
    assert steps >= 1 and all(program[k] <= lim for k, lim in limits.items()), program
    control, _ = calibrate.read_seed(driver, "control", 2**31 + 79, 0.2)
    assert any(control[k] > lim for k, lim in limits.items()), control


def test_seeded_weights_follow_basicsr_and_the_assumed_scales(tmp_path):
    layers = seeded_weights(ARCH, 5, CONFIG["assumed"])
    assert list(layers) == [name for name, _, _ in counts.layer_shapes(ARCH)]
    assert len(layers) == 1 + 2 * 15 + 5
    w, b = layers["body.1.rdb3.conv4"]
    assert w.shape == (32, 160, 3, 3) and not b.any()
    gain = CONFIG["assumed"]["dense_block_init_scale"]
    assert abs(w.std() - gain * math.sqrt(2 / (160 * 9))) < 0.01 * w.std()
    w, b = layers["conv_up2"]
    assert abs(w).max() <= 1 / math.sqrt(64 * 9) and b.any()
    assert np.all(layers["conv_last"][1] == CONFIG["assumed"]["conv_last_bias"])
    again = seeded_weights(ARCH, 5, CONFIG["assumed"])
    assert all(np.array_equal(layers[k][0], again[k][0]) for k in layers)
    path = str(tmp_path / "w.npz")
    write_weights(path, ARCH, layers)
    ref = ReferenceRealESRGAN(path, "cpu")
    assert ref.num_block == 2 and torch.equal(ref.layers["conv_hr"][1],
                                              torch.from_numpy(layers["conv_hr"][1]))
    with pytest.raises(ValueError, match="no 2x Real-ESRGAN"):
        ReferenceRealESRGAN(str(spec.ROOT / "elvis_tpu_torch/weights/srnet_student.npz"), "cpu")


def test_flops_by_hand():
    f, g = 64, 32
    dense = sum(2 * 9 * (f + k * g) * g for k in range(4)) + 2 * 9 * (f + 4 * g) * f
    body = 2 * 9 * 12 * f + 69 * dense + 2 * 9 * f * f  # at a quarter of the input pixels
    head = 2 * 9 * f * f * (1 + 4 + 4) + 4 * 2 * 9 * f * 3
    arch = CONFIG["arch"]
    # stage inputs 135x240 (padded to 136x240), 270x480, 540x960 for 8 frames
    want = 8 * sum(body * hp * w // 4 + head * hp * w
                   for hp, w in ((136, 240), (270, 480), (540, 960)))
    assert counts.segment_flops(arch, 8, 1080, 1920, 3) == want
    assert abs(want / 1e12 - 48.82) < 0.01
    peaks = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    assert counts.segment_conv_bound_s(arch, 8, 1080, 1920, 3, peaks) >= want / 989e12
