"""Device time of the operations launched inside the program's ``score.*``
spans (complexity, saliency, fusion) in the traced segments, per segment,
in ms."""

PREFIX = "score."


def read(run):
    if run.trace is None or not run.trace.segments:
        return None
    names = [n for n in run.trace.spans if n.startswith(PREFIX)]
    if not names:
        return None
    ops = {id(op): op for n in names for op in run.trace.launched_within(n)}
    return sum(op.dur_us for op in ops.values()) / 1e3 / run.trace.segments
