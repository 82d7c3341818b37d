"""Share of the SR nets' trunk convolutions whose epilogue (bias, leaky
ReLU, residual sums) ran as the one fused kernel, over every trunk conv of
the run, from the program's ``nets`` counters (``epilogue.fused`` and
``epilogue.plain``), in %. None where the program has no such counters."""


def read(run):
    try:
        from elvis_tpu_torch.utils.trace import counters
    except ImportError:  # a program without the counter registry
        return None
    c = counters()
    fused, plain = c.get("nets.epilogue.fused", 0), c.get("nets.epilogue.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
