"""Entry: the port's RFMIP driver (``drivers/rfmip.rfmip_lw_sw``) on its
fused route (one LW angle, RRTMGP gas optics: the fused LW and SW
kernels), one block, the four fluxes read back to the host as numpy
arrays, as the example writes them to its files."""
from __future__ import annotations

from rte_rrtmgp_tpu_torch.drivers.rfmip import rfmip_lw_sw

from torch_bench.entries import common

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn")


class Entry:
    def __init__(self, data: dict, config: dict, device):
        self.p = common.optics(data, device)
        self.inputs = [common.rfmip_data(s, config) for s in data["pool"]]

    def forward(self, x, span):
        with span("rfmip_lw_sw"):
            return rfmip_lw_sw(x, self.p.gas_lw, self.p.gas_sw)
