"""Device time of the operations launched inside the program's
``srnet.body`` spans (an RRDB net's chain of residual-in-residual dense
blocks and its closing conv) in the traced segments, per segment, in ms.
None where the program records no such span."""

BODY = "srnet.body"


def read(run):
    if run.trace is None or not run.trace.segments or BODY not in run.trace.spans:
        return None
    return sum(op.dur_us for op in run.trace.launched_within(BODY)) / 1e3 / run.trace.segments
