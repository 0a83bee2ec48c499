"""Device milliseconds per sweep of the whole-grid stream's copies: the
host-to-device and device-to-host copies in the traced window (the
chunks' uploads, the fluxes' readbacks, and the input prep's own small
copies). Moves ``columns_per_s`` where the copies are not hidden beside
the steps."""
from torch_bench import harness

LAYER = "stream"


def read(run):
    t = harness.load("work", "stream_copy").copy_seconds(run)
    if not t or not run.steps:
        return None
    return 1e3 * t / run.steps
