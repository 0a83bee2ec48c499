"""The aerosol lookup kernel (``csrc/aerosol_props.cu``) in the
whole-grid stream with aerosols: the share, in %, of its device time in
the traced window that its bound would take (the larger of its bytes at
the card's bandwidth and its operations at the float32 peak,
``work/aerosol_props.py``); nothing where the trace holds none of it."""
LAYER = "kernels"


def read(run):
    return run.roofline("aerosol_props_kernel", "aerosol_props")
