"""95th percentile over every segment of the window of one segment's
restore, from the call to its output being ready (host clock, after a
synchronise), in ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3 if run.latencies_s else None
