"""Set-up: process start to the first timed segment (host clock)."""


def read(run):
    return run.setup_s
