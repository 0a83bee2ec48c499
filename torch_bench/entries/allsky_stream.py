"""Entry: the port's whole-grid stream (``parallel/scaling.AllSkyStream``).
Each grid of the pool is held in pinned host memory; one sweep a step:
the grid goes up in chunks of the configuration's ``chunk`` columns, the
fused all-sky step runs LW on every column and SW on the day columns
(``mu0 > 0``), and the five flux profiles come back into host buffers.
The value checks are off inside the sweep, as the reference's timed loop
(rrtmgp_allsky.F90:332-335) runs. A program without the stream cannot
load this entry and the run ends there."""
from __future__ import annotations

import torch

from rte_rrtmgp_tpu_torch.config import checks_disabled
from rte_rrtmgp_tpu_torch.parallel.scaling import AllSkyStream

from torch_bench.entries import common

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")


def _host(state: dict) -> dict:
    """A generated state with its tensors in host memory."""
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


class Entry:
    def __init__(self, data: dict, config: dict, device):
        p = common.optics(data, device)
        self.stream = AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw,
                                   chunk=config["chunk"], device=device)
        self.inputs = [self.stream.pin(common.allsky_inputs(_host(s)))
                       for s in data["pool"]]

    def forward(self, x, span):
        with checks_disabled(), span("ne30pg2_stream"):
            return tuple(self.stream.run(x))
