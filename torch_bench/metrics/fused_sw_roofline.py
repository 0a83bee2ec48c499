"""Row 3, the fused SW step: the share, in %, of its device time in the
traced window that its bound would take (the larger of its bytes at the
card's bandwidth and its operations at the float32 peak,
``work/fused_sw.py``)."""
LAYER = "kernels"


def read(run):
    return run.roofline("fused_sw_kernel", "fused_sw")
