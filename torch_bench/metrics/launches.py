"""Device kernels per step (copies and fills not counted), from the
profiler's trace of the window: the plain-PyTorch launches of the optics
front ends and the descriptor prep, with the hand-written kernels."""
LAYER = "optics front ends"


def read(run):
    return run.launches_per_step
