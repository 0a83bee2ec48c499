"""Row 2, the fused LW step: the share, in %, of its device time in the
traced window that its bound would take (the larger of its bytes at the
card's bandwidth and its operations at the float32 peak,
``work/fused_lw.py``)."""
LAYER = "kernels"


def read(run):
    return run.roofline("fused_lw_kernel", "fused_lw")
