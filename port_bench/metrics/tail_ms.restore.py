"""Device time of the operations launched inside the program's
``srnet.tail`` spans (the SR nets' float32 tail: the 3x3 conv to 3 channels
at the output resolution, with whatever casts and copies its route makes)
in the traced segments, per segment, in ms. None where the program records
no such span."""

TAIL = "srnet.tail"


def read(run):
    if run.trace is None or not run.trace.segments or TAIL not in run.trace.spans:
        return None
    return sum(op.dur_us for op in run.trace.launched_within(TAIL)) / 1e3 / run.trace.segments
