"""Entry: the port's whole-grid stream (``parallel/scaling.AllSkyStream``)
with MERRA aerosols. As ``allsky_stream``, and the stream is given the LW
and SW aerosol optics, built on the card from the generator's tables
(``AerosolOpticsMERRA.load`` takes them there, with no trip through the
host): each grid's aerosol fields (type, size, mass, relative humidity)
go up with the chunk, join the day gather, and the fused step runs with
``use_aerosols``. The value checks are off inside the sweep, as the
reference's timed loop (rrtmgp_allsky.F90:332-335) runs. ``sweep`` and
``increments`` run the same stream and optics for the check, after the
window (``steps/grid_aer.py``). A program whose stream takes no aerosol
optics cannot build this entry and the run ends there."""
from __future__ import annotations

import torch

from rte_rrtmgp_tpu_torch.config import checks_disabled
from rte_rrtmgp_tpu_torch.models.rrtmgp.aerosol_optics import \
    AerosolOpticsMERRA
from rte_rrtmgp_tpu_torch.parallel.scaling import (AEROSOL_FIELDS,
                                                   AllSkyStream)

from torch_bench.entries import common

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")


def inputs(state: dict):
    """The port's ``AllSkyInputs`` of one generated state, aerosols on."""
    return common.allsky_inputs(state)._replace(
        **{f: state[f] for f in AEROSOL_FIELDS})


def _host(state: dict) -> dict:
    """A generated state with its tensors in host memory."""
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


class Entry:
    def __init__(self, data: dict, config: dict, device):
        p = common.optics(data, device)
        aer = lambda key: AerosolOpticsMERRA.load(
            dtype=torch.float32, device=device, **data[key])
        self.stream = AllSkyStream(
            p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw, chunk=config["chunk"],
            device=device, aerosol_lw=aer("aerosol_lw"),
            aerosol_sw=aer("aerosol_sw"))
        self.inputs = [self.stream.pin(inputs(_host(s)))
                       for s in data["pool"]]

    def forward(self, x, span):
        with checks_disabled(), span("ne30pg2_aer_stream"):
            return tuple(self.stream.run(x))

    def sweep(self, state: dict):
        """The five fluxes of one sweep of the stream on a generated
        state (the check's, after the window), copied out of the
        stream's host buffers."""
        with checks_disabled():
            out = self.stream.run(self.stream.pin(inputs(_host(state))))
            return tuple(f.clone() for f in out)

    def increments(self, state: dict):
        """The by-band increments that the stream's own cloud and aerosol
        optics give a generated state on its device, as the step folds
        them (``drivers/allsky._absorption_lanes``, ``_scattering_lanes``):
        the LW absorption of both, and the SW delta-scaled (tau, ssa, g)
        of both combined; each (ncol, nlay, nbnd)."""
        x, s = inputs(state), self.stream
        aer = (x.aero_type, x.aero_size, x.aero_mass, x.relhum)
        cloud = lambda c: c.cloud_optics_lanes(x.lwp, x.iwp, x.rel, x.dei)
        with checks_disabled():
            lw = s.aerosol_lw.absorption_lanes(*aer, cloud=cloud(s.cloud_lw))
            sw = s.aerosol_sw.scattering_lanes(*aer, cloud=cloud(s.cloud_sw))
        return tuple(t.permute(2, 1, 0) for t in (lw,) + tuple(sw))
