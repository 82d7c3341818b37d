"""Device time of the operations launched inside the program's
``srnet.upsample_head`` spans (Real-ESRGAN's two nearest-neighbour stages
and ``conv_up1``, ``conv_up2``, ``conv_hr``, ``conv_last``) in the traced
segments, per segment, in ms. None where the program records no such
span."""

HEAD = "srnet.upsample_head"


def read(run):
    if run.trace is None or not run.trace.segments or HEAD not in run.trace.spans:
        return None
    return sum(op.dur_us for op in run.trace.launched_within(HEAD)) / 1e3 / run.trace.segments
