"""Device time of the operations launched inside the program's
``e2fgvi.propagation`` spans (E2FGVI's two-way feature propagation (flow
warps, offset stacks, deformable convs, backbone convs and the fusion)) in
the traced segments, per segment, in ms. None where the program records no
such span."""

SPAN = "e2fgvi.propagation"


def read(run):
    if run.trace is None or not run.trace.segments or SPAN not in run.trace.spans:
        return None
    return sum(op.dur_us for op in run.trace.launched_within(SPAN)) / 1e3 / run.trace.segments
