"""The share of the traced window, in %, in which no operation ran on
the card: 1 less the union of the device intervals (kernels, copies,
fills) over the window's wall time. The profiler's own overhead
lengthens the wall, so it reads above an untraced run's."""
LAYER = "device"


def read(run):
    if not run.busy_s or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
