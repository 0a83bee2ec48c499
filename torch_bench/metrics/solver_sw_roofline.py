"""Row 9, the public SW two-stream solver: the share, in %, of its device
time in the traced window that its bound would take (the larger of its
bytes at the card's bandwidth and its operations at the float32 peak,
``work/solver_sw.py``)."""
LAYER = "kernels"


def read(run):
    return run.roofline("solver_sw_kernel", "solver_sw")
