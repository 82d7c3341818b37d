"""Device kernels launched inside the program's ``nvc.encode.intra`` spans
(each plane's intra frames: raw and wavefront alternatives and the arbiter)
in the traced segments, per frame encoded."""

SPAN = "nvc.encode.intra"


def read(run):
    if run.trace is None or not run.trace.frames or SPAN not in run.trace.spans:
        return None
    kernels = [op for op in run.trace.launched_within(SPAN) if op.cat == "kernel"]
    return len(kernels) / run.trace.frames
