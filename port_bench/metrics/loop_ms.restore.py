"""Device time of the operations launched inside the program's
``restore.progressive`` spans and outside its ``restore.upsample`` spans
(the loop's area resizes, re-injection, casts and rounding, apart from the
nets or Lanczos) in the traced segments, per segment, in ms."""

LOOP, STAGE = "restore.progressive", "restore.upsample"


def read(run):
    if run.trace is None or not run.trace.segments or LOOP not in run.trace.spans:
        return None
    stage = {id(op) for op in run.trace.launched_within(STAGE)}
    loop = [op for op in run.trace.launched_within(LOOP) if id(op) not in stage]
    return sum(op.dur_us for op in loop) / 1e3 / run.trace.segments
