"""Device time of the operations launched under ``aten::cat`` inside the
program's ``srnet.body`` spans (the dense blocks' concatenations) in the
traced segments, per segment, in ms. None where the program records no
such span."""

BODY = "srnet.body"


def read(run):
    if run.trace is None or not run.trace.segments or BODY not in run.trace.spans:
        return None
    body = {id(op) for op in run.trace.launched_within(BODY)}
    cats, _ = run.trace.under_op("aten::cat")
    return sum(op.dur_us for op in cats if id(op) in body) / 1e3 / run.trace.segments
