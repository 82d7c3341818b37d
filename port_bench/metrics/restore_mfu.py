"""The nets' FLOPs for every segment completed in the window, over the
window's wall time and the bfloat16 dense peak, in %."""


def read(run):
    flops = run.counts.get("flops_per_step")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops * run.steps / run.window_s / run.peaks()["bf16_flops"]
