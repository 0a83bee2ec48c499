"""The stream's copies: the share, in %, of their device time in the
traced window that the sweep's bytes would take at the link's peak per
direction (``work/stream_copy.py``: the fields the step reads, the day
indices and the five flux profiles; the peak read from the card's PCIe
link)."""
from torch_bench import harness

LAYER = "stream"


def read(run):
    copies = harness.load("work", "stream_copy")
    t = copies.copy_seconds(run)
    if not t or not run.steps:
        return None
    nbytes, _ = run.work("stream_copy")
    return 100.0 * nbytes / copies.LINK_BYTES_PER_S * run.steps / t
