"""Entry: the port's fused all-sky step (``drivers/allsky.allsky_step_lw``
then ``allsky_step_sw``, the step ``build_allsky_step`` returns): cloud
optics, the descriptor prep and one fused LW and one fused SW kernel;
clouds on, aerosols off. The fluxes stay on the device."""
from __future__ import annotations

from rte_rrtmgp_tpu_torch.drivers.allsky import allsky_step_lw, allsky_step_sw

from torch_bench.entries import common

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")


class Entry:
    def __init__(self, data: dict, config: dict, device):
        self.p = common.optics(data, device)
        self.inputs = [common.allsky_inputs(s) for s in data["pool"]]

    def forward(self, x, span):
        p = self.p
        with span("allsky_step_lw"):
            lw = allsky_step_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
        with span("allsky_step_sw"):
            sw = allsky_step_sw(x, p.gas_sw, cloud_optics=p.cld_sw)
        return lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir

    with_leaves = staticmethod(common.with_leaves)
