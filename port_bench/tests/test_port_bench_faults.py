"""A run of each cell on the CPU at a small size, past the harness's look
for a chip: sound, ``correct`` is true; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (a step that hands back its input unchanged, half of the segment left
out, an answer altered where it is produced). One chip: no exchange
between chips to leave out."""

import pytest
import torch

from port_bench.harness import cell

from conftest import SMALL


def _run(workload, hook=None, seconds=0.5):
    return cell.run_cell(workload, 2**31 + 101, seconds, False, device="cpu", overrides=SMALL,
                         driver_hook=hook)


def _unchanged(fn):
    return lambda f, m, b: f


def _half(fn):
    return lambda f, m, b: fn(f[: f.shape[0] // 2], m[: m.shape[0] // 2], b)


def _altered(fn):
    def altered(f, m, b):
        out = fn(f, m, b).clone()
        out[0] = torch.clamp(out[0].int() + 6, 0, 255).to(out.dtype)
        return out

    return altered


def _block_altered(fn):
    def altered(f, m, b):
        out = fn(f, m, b).clone()
        out[-1, 8:16, 8:16] = 255 - out[-1, 8:16, 8:16]
        return out

    return altered


FAULTS = {"unchanged": _unchanged, "half": _half, "altered_frame": _altered,
          "altered_block": _block_altered}


@pytest.mark.parametrize("workload", ["student_1080p_restore", "rrdb_1080p_restore",
                                      "student_1080p_encode", "student_1080p_client"])
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", ["student_1080p_restore", "student_1080p_client"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_restore_faults_are_not_correct(workload, fault):
    def hook(driver):
        driver.backend = FAULTS[fault](driver.backend)

    assert not _run(workload, hook)["correct"]


def _decode_altered(driver):
    decode = driver.decode

    def altered(stream, device):
        frames, fps = decode(stream, device=device)
        frames = frames.clone()
        frames[1] = 255 - frames[1]
        return frames, fps

    driver.decode = altered


def _decode_unchanged(driver):
    first = {}

    def stale(stream, device):  # always the first stream's frames
        if "out" not in first:
            first["out"] = driver_decode(stream, device=device)
        return first["out"]

    driver_decode = driver.decode
    driver.streams = driver.streams[1:] + driver.streams[:1]
    driver.decode = stale


@pytest.mark.parametrize("fault", [_decode_altered, _decode_unchanged])
def test_client_decode_faults_are_not_correct(fault):
    assert not _run("student_1080p_client", fault)["correct"]


def _skip_degrade(driver):
    down = driver.downsample
    driver.downsample = lambda f, s, b: (f, down(f, s, b)[1])


def _half_encoded(driver):
    enc = driver.encode
    driver.encode = lambda f, **kw: enc(f[: f.shape[0] // 2], **kw)


def _stream_altered(driver):
    enc = driver.encode

    def altered(f, **kw):
        s = bytearray(enc(f, **kw))
        mid = len(s) // 2
        s[mid:mid + 16] = bytes(255 - x for x in s[mid:mid + 16])
        return bytes(s)

    driver.encode = altered


def _scores_unchanged(driver):
    driver.score = lambda f: torch.zeros(f.shape[0], f.shape[1] // 8, f.shape[2] // 8)


def _levels_altered(driver):
    down = driver.downsample

    def altered(f, s, b):
        d, lv = down(f, s, b)
        lv = lv.clone()
        lv[0, 0, 0] = (lv[0, 0, 0] + 1) % 4
        return d, lv

    driver.downsample = altered


@pytest.mark.parametrize("fault", [_skip_degrade, _half_encoded, _stream_altered,
                                   _scores_unchanged, _levels_altered])
def test_encode_faults_are_not_correct(fault):
    assert not _run("student_1080p_encode", fault)["correct"]
