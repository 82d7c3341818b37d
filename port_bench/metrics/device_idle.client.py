"""Share of the traced window in which no operation ran on the device, in %.
The arithmetic is ``Trace.idle_percent``; this file only names the metric
that moves ``client_fps``."""


def read(run):
    return None if run.trace is None else run.trace.idle_percent()
