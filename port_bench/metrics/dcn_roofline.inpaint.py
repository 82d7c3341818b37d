"""The deformable convolutions' least time (per call, the larger of its
GEMM's FLOPs over the bf16 peak and its least bytes, features, offsets and
mask in and output out, over the bandwidth; ``counts/e2fgvi.py``) over the
device time of the operations launched inside the program's ``e2fgvi.dcn``
spans (the sampling and the GEMM, whatever implements them) in the traced
segments, in %. None where the program records no such span."""

DCN = "e2fgvi.dcn"


def read(run):
    bound = run.counts.get("dcn_bound_s_per_step")
    if run.trace is None or not bound or DCN not in run.trace.spans:
        return None
    busy = sum(op.dur_us for op in run.trace.launched_within(DCN)) / 1e6
    return 100.0 * bound * run.trace.segments / busy if busy > 0 else None
