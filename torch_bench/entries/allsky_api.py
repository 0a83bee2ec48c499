"""Entry: the all-sky step through the port's public API
(``drivers/allsky.allsky_api_lw`` then ``allsky_api_sw``): gas optics
(the major, minor and Rayleigh gathers, Planck sources in plain
PyTorch), cloud optics, ``increment`` and ``delta_scale``, then
``rte_lw`` and ``rte_sw``, as a user of the library composes them;
clouds on, aerosols off. The fluxes stay on the device."""
from __future__ import annotations

from rte_rrtmgp_tpu_torch.drivers.allsky import allsky_api_lw, allsky_api_sw

from torch_bench.entries import common

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")


class Entry:
    def __init__(self, data: dict, config: dict, device):
        self.p = common.optics(data, device)
        self.inputs = [common.allsky_inputs(s) for s in data["pool"]]

    def forward(self, x, span):
        p = self.p
        with span("allsky_api_lw"):
            lw = allsky_api_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
        with span("allsky_api_sw"):
            sw = allsky_api_sw(x, p.gas_sw, cloud_optics=p.cld_sw)
        return lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir

    with_leaves = staticmethod(common.with_leaves)
