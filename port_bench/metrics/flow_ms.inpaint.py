"""Device time of the operations launched inside the program's ``e2fgvi.flow``
spans (SPyNet's flows between neighbouring local frames, both ways) in the
traced segments, per segment, in ms. None where the program records no such
span."""

SPAN = "e2fgvi.flow"


def read(run):
    if run.trace is None or not run.trace.segments or SPAN not in run.trace.spans:
        return None
    return sum(op.dur_us for op in run.trace.launched_within(SPAN)) / 1e3 / run.trace.segments
