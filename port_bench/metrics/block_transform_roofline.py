"""The hand kernel's byte bound (uint8 frames read and written, the level
map and the table once, at the HBM bandwidth) over its mean device time per
launch in the trace, found by kernel name, in %."""

KERNEL = "block_transform_kernel<"


def read(run):
    nbytes = run.counts.get("block_transform_bytes")
    if run.trace is None or not nbytes:
        return None
    times = [op.dur_us / 1e6 for op in run.trace.ops if KERNEL in op.name]
    if not times:
        return None
    return 100.0 * nbytes / run.peaks()["hbm_bytes_per_s"] / (sum(times) / len(times))
