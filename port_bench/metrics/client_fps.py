"""Frames completed over the measured window (host clock)."""


def read(run):
    return run.frames / run.window_s if run.window_s else None
