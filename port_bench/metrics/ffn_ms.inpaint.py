"""Device time of the operations launched inside the program's
``e2fgvi.ffn`` spans (the eight transformer blocks' feed-forwards: fc1, the
fold, its normalisation, the unfold, GELU and the cast, fc2) in the traced
segments, per segment, in ms. None where the program records no such span."""

SPAN = "e2fgvi.ffn"


def read(run):
    if run.trace is None or not run.trace.segments or SPAN not in run.trace.spans:
        return None
    return sum(op.dur_us for op in run.trace.launched_within(SPAN)) / 1e3 / run.trace.segments
