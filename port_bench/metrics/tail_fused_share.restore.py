"""Share of the SR nets' float32 tail calls (``_TailConv``, Real-ESRGAN's
``conv_last``) that ran as the hand-written ``tail_conv`` kernel, over every
tail call of the run, from the program's ``nets`` counters (``tail.fused``
and ``tail.plain``), in %. None where the program has no such counters."""


def read(run):
    try:
        from elvis_tpu_torch.utils.trace import counters
    except ImportError:  # a program without the counter registry
        return None
    c = counters()
    fused, plain = c.get("nets.tail.fused", 0), c.get("nets.tail.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
