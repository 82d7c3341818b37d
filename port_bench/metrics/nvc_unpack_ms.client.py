"""Host time inside the program's ``nvc.decode.unpack`` spans
(``read_stream``: the range decoder, inverse zig-zag and DC-DPCM; no device
operation) in the traced segments, per frame decoded, in ms."""

SPAN = "nvc.decode.unpack"


def read(run):
    if run.trace is None or not run.trace.frames or SPAN not in run.trace.spans:
        return None
    return sum(b - a for a, b in run.trace.spans[SPAN]) / 1e3 / run.trace.frames
