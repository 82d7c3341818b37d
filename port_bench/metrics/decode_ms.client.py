"""Host clock around ``nvc.decode`` ending in a synchronise, per frame
decoded over the window, in ms."""


def read(run):
    spans = run.spans.get("decode_s")
    return 1e3 * sum(spans) / run.frames if spans and run.frames else None
