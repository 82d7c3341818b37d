"""Coded bytes per frame over every encode of the run, from the program's
``nvc`` counters (``encode.bytes`` over ``encode.frames``). A faster encode
that spends more bits is another result, not a faster one."""


def read(run):
    try:
        from elvis_tpu_torch.utils.trace import counters
    except ImportError:  # a program without the counter registry
        return None
    c = counters()
    frames = c.get("nvc.encode.frames")
    return c["nvc.encode.bytes"] / frames if frames else None
