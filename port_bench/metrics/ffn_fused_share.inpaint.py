"""Share of E2FGVI-HQ's feed-forward calls whose fold, unfold and GELU ran as
the hand-written ``ffn_fold`` kernel, over every feed-forward call of the
run, from the program's ``nets`` counters (``ffn.fused`` and ``ffn.plain``),
in %. None where the program has no such counters."""


def read(run):
    try:
        from elvis_tpu_torch.utils.trace import counters
    except ImportError:  # a program without the counter registry
        return None
    c = counters()
    fused, plain = c.get("nets.ffn.fused", 0), c.get("nets.ffn.plain", 0)
    return 100.0 * fused / (fused + plain) if fused + plain else None
