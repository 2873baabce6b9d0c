"""device_idle: the share of the traced window in which no operation ran on
the device, in %: one minus the busy seconds over the window's seconds,
both from the trace of the device alone (``benchmark/trace.py::busy``)."""


def read(run):
    if run.busy is None:
        return None
    busy_s, window_s = run.busy
    return 100.0 * (1.0 - busy_s / window_s)
