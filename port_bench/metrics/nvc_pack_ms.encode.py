"""Host time inside the program's ``nvc.encode.pack`` spans (``write_stream``:
zig-zag, DC-DPCM, the range coder and the container; no device operation)
in the traced segments, per frame encoded, in ms."""

SPAN = "nvc.encode.pack"


def read(run):
    if run.trace is None or not run.trace.frames or SPAN not in run.trace.spans:
        return None
    return sum(b - a for a, b in run.trace.spans[SPAN]) / 1e3 / run.trace.frames
