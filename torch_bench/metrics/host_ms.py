"""Host milliseconds per step from the step's call to its return, before
the synchronize: what the entry points and everything under them cost
the host (benchmark spans around the call, mean over the traced
window's steps). Moves ``columns_per_s`` while the host sets the pace."""
LAYER = "entry points"


def read(run):
    if not run.host_s:
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)
