"""Row 5, the minor-gas gather (its four launches a step): the share, in %,
of its device time in the traced window that its bound would take (the
larger of its bytes at the card's bandwidth and its operations at the
float32 peak, ``work/gas_minor.py``)."""
LAYER = "kernels"


def read(run):
    return run.roofline("gas_minor_kernel", "gas_minor")
