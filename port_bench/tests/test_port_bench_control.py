"""The controls at a size a test can hold, through ``calibrate.py``'s own
functions: the program's readings pass the configuration's limits, the
reference put in the program's place one precision below fails one of
them, and the encode's stream faults fail the stream's number."""

import pytest
import torch

from port_bench import calibrate

from conftest import SMALL

SIZE = dict(SMALL, height=72, width=104, segment_frames=8)


def _failed(driver, got):
    return [k for k, lim in driver.checks["limits"].items() if got[k] > lim]


@pytest.mark.parametrize("workload", ["student_1080p_restore", "rrdb_1080p_restore",
                                      "student_1080p_encode", "student_1080p_client"])
def test_control_fails_a_limit(workload):
    driver = calibrate.make_driver(workload, 2**31 + 77, 0.2, torch.device("cpu"),
                                   overrides=SIZE)
    program, steps = calibrate.read_seed(driver, "program", 2**31 + 78, 0.2)
    assert steps >= 1 and not _failed(driver, program), program
    control, _ = calibrate.read_seed(driver, "control", 2**31 + 79, 0.2)
    assert _failed(driver, control), control


def test_stream_faults_fail_the_stream_number():
    driver = calibrate.make_driver("student_1080p_encode", 2**31 + 80, 0.2,
                                   torch.device("cpu"), overrides=SIZE)
    faults, _ = calibrate.read_seed(driver, "fault", 2**31 + 81, 0.2)
    assert set(faults) == {"stale_stream", "altered_stream"}
    for name, got in faults.items():
        assert "stream_mse" in _failed(driver, got), (name, got)
