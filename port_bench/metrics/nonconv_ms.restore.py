"""Device time per traced segment of every operation not launched under a
convolution (Lanczos phase taps, activations, area resizes, interleave,
re-injection, casts), in ms."""


def read(run):
    if run.trace is None or not run.trace.segments:
        return None
    _, rest = run.trace.under_op("aten::convolution")
    return sum(op.dur_us for op in rest) / 1e3 / run.trace.segments
