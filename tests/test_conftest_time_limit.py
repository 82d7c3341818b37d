"""The per-phase time limit of the repository's root conftest.py, tried in a
child pytest run with a one-second limit on a test that sleeps, a fixture
that sleeps, a fast test and the test the conftest marks slow."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

CHILD_TESTS = textwrap.dedent("""
    import time

    import pytest


    @pytest.fixture
    def sleepy():
        time.sleep(30)


    def test_sleeper():
        time.sleep(30)


    def test_fast():
        assert True


    def test_sleepy_fixture(sleepy):
        pass
""")

# Named as the conftest's slow test, so it runs past the limit and passes.
CHILD_SLOW_TEST = textwrap.dedent("""
    import time


    class TestTemporalHaloEquivalence:
        def test_mc_inpaint_sharded_matches_unsharded(self):
            time.sleep(2.5)
""")


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    d = tmp_path_factory.mktemp("time_limit")
    shutil.copy(os.path.join(os.path.dirname(__file__), os.pardir, "conftest.py"), d)
    (d / "pytest.ini").write_text("[pytest]\nmarkers =\n    slow: long\n")
    (d / "tests").mkdir()
    (d / "tests" / "test_child.py").write_text(CHILD_TESTS)
    (d / "tests" / "test_parallel.py").write_text(CHILD_SLOW_TEST)
    env = dict(os.environ, ELVIS_TEST_PHASE_LIMIT_S="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:xdist", "-p", "no:randomly",
         "-p", "no:cacheprovider", "-rA", "tests"],
        cwd=d, env=env, capture_output=True, text=True, timeout=120,
    )
    return r.stdout, r.stderr


def test_sleeping_test_fails_at_the_limit_with_its_stack(child):
    out, err = child
    assert "FAILED tests/test_child.py::test_sleeper" in out
    assert "call of tests/test_child.py::test_sleeper ran past the time limit of 1 s" in out
    assert "most recent call first" in err
    assert "in test_sleeper" in err


def test_fast_test_passes(child):
    """So does the test the conftest marks slow, which has no limit."""
    out, _ = child
    assert "PASSED tests/test_child.py::test_fast" in out
    assert ("PASSED tests/test_parallel.py::TestTemporalHaloEquivalence::"
            "test_mc_inpaint_sharded_matches_unsharded") in out
    assert "1 failed, 2 passed, 1 error" in out


def test_sleeping_fixture_fails_setup_at_the_limit(child):
    out, err = child
    assert "ERROR tests/test_child.py::test_sleepy_fixture" in out
    assert "setup of tests/test_child.py::test_sleepy_fixture ran past the time limit of 1 s" in out
    assert "in sleepy" in err
