"""The share, in %, of the copies' device time that ran beside other
device work: (the sum of every device op's time - the union of the
device intervals) over the copies' time in the traced window. The
copies run on their own streams, the steps on the current one, so what
the union saves is time two ops shared."""
from torch_bench import harness

LAYER = "stream"


def read(run):
    t = harness.load("work", "stream_copy").copy_seconds(run)
    if not t or run.busy_s is None:
        return None
    total = sum(s for s, _ in run.kernels.values())
    return 100.0 * (total - run.busy_s) / t
