"""The convolutions' least time (per conv, FLOPs over the peak of its type
or bytes over the bandwidth, from the configuration's widths) over the
device time of the kernels launched under ``aten::convolution`` in the
traced segments, in %."""


def read(run):
    bound = run.counts.get("conv_bound_s_per_step")
    if run.trace is None or not bound:
        return None
    convs, _ = run.trace.under_op("aten::convolution")
    busy = sum(op.dur_us for op in convs) / 1e6
    return 100.0 * bound * run.trace.segments / busy if busy > 0 else None
