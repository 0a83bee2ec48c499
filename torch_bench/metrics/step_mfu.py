"""The whole step's share, in %, of the card's float32 peak: the
operations the cell's step needs, counted from its shapes by ``work/``
(the fused LW and SW forward counts for every forward cell, whatever path
runs it, and the fused adjoints' counts besides for a gradient step),
over the host's wall time of the untraced stretch that a traced run
times after its window (``harness.UNTRACED_S``), so the profiler's
overhead is not in it. It reads the same work whatever implements the
step, so it bounds a gain when a kernel leaves the path."""
LAYER = "whole step"


def read(run):
    if not run.untraced_steps or not run.untraced_s:
        return None
    from torch_bench import peaks
    names = ["fused_lw", "fused_sw"]
    if run.cell["step"] == "grad":
        names += ["fused_lw_bwd", "fused_sw_bwd"]
    ops = sum(run.work(n)[1] for n in names)
    return (100.0 * ops * run.untraced_steps / run.untraced_s
            / peaks.F32_PER_S)
