"""Rules of the tier-1 test run for the tests under tests/ (tests/conftest.py
sets up their JAX CPU devices): a time limit for every test phase, and one
long JAX-package test kept to `-m slow`.
"""

import contextlib
import faulthandler
import os
import pathlib
import signal

import pytest

TESTS_DIR = pathlib.Path(__file__).parent / "tests"

# Seconds one test phase (setup or call) may run before it fails: the
# larger of 300 s and twice the longest non-slow phase under the suite's own
# load (`-n 6 --dist loadfile` on 8 CPU cores), which was the setup of
# test_torch_presley.py::test_run_presley_rows_equal_jax at 195.02 s and, in
# a later run, 245.95 s; rounded up. Slow tests have no limit. The variable
# is set only by test_conftest_time_limit.py's child run.
TEST_PHASE_LIMIT_S = int(os.environ.get("ELVIS_TEST_PHASE_LIMIT_S", 500))

# Marked slow here: 392 s alone and 739 s under the suite's load, almost all
# of it XLA compiling the JAX package's eager shard_map anew on every call.
# The port's tests/test_torch_parallel.py::test_temporal_fill_sharded_equals_unsharded
# checks the same property on elvis_tpu_torch in tier-1.
SLOW_NODEIDS = {
    "tests/test_parallel.py::TestTemporalHaloEquivalence::"
    "test_mc_inpaint_sharded_matches_unsharded",
}

_stderr_fd = pytest.StashKey[int]()


def pytest_configure(config):
    # Capture is off here, so this is the terminal's stderr: a stack dump
    # written to it shows at once, even if the phase never returns.
    config.stash[_stderr_fd] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects by marker
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW_NODEIDS:
            item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def _phase_time_limit(item, when):
    """Dump every thread's stack once the phase has run `TEST_PHASE_LIMIT_S`
    seconds, and fail it a second later.

    The dump also shows a hang inside C code (an XLA compile, a subprocess
    wait), which the signal cannot interrupt. The alarm needs the main
    thread, which is where pytest, and xdist's workers, run tests.
    """
    if not item.path.is_relative_to(TESTS_DIR) or item.get_closest_marker("slow"):
        yield
        return

    def expire(signum, frame):
        __tracebackhide__ = True
        pytest.fail(f"{when} of {item.nodeid} ran past the time limit of "
                    f"{TEST_PHASE_LIMIT_S} s per test phase (stacks dumped to stderr)")

    faulthandler.dump_traceback_later(TEST_PHASE_LIMIT_S, exit=False,
                                      file=item.config.stash[_stderr_fd])
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_PHASE_LIMIT_S + 1)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _phase_time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _phase_time_limit(item, "call"):
        return (yield)
