"""A sweep's share, in %, of the card's float32 peak: the fused LW
operations of every column and the fused SW operations of the day share
of the columns (from the cell's mu0 range), counted from the shapes by
``work/fused_lw.py``, ``work/fused_sw.py`` and ``work/stream_copy.py``,
over the host's wall time of the untraced stretch that a traced run
times after its window (``harness.UNTRACED_S``)."""
from torch_bench import harness

LAYER = "stream"


def read(run):
    if not run.untraced_steps or not run.untraced_s:
        return None
    from torch_bench import peaks
    share = harness.load("work", "stream_copy").day_share(run.cell)
    ops = run.work("fused_lw")[1] + share * run.work("fused_sw")[1]
    return (100.0 * ops * run.untraced_steps / run.untraced_s
            / peaks.F32_PER_S)
