"""The program's objects built from the generator's data, through the
port's public constructors: the gas optics (``KDist.from_raw``), the
cloud optics (``CloudOpticsRRTMGP.load``) and the all-sky and RFMIP
inputs. Shared by the entries; nothing here is timed."""
from __future__ import annotations

from typing import NamedTuple

import torch

from torch_bench.traffic.generator import GASES, host


class Optics(NamedTuple):
    gas_lw: object
    gas_sw: object
    cld_lw: object
    cld_sw: object


def optics(data: dict, device) -> Optics:
    from rte_rrtmgp_tpu_torch.models.rrtmgp.cloud_optics import \
        CloudOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist
    f32 = torch.float32
    gas = lambda raw: GasOpticsRRTMGP(KDist.from_raw(
        GASES, dtype=f32, device=device, **host(raw)))
    cld = lambda key: (CloudOpticsRRTMGP.load(dtype=f32, device=device,
                                              **host(data[key]))
                       if key in data else None)
    return Optics(gas(data["lw"]), gas(data["sw"]), cld("cloud_lw"),
                  cld("cloud_sw"))


def allsky_inputs(state: dict):
    """The port's ``AllSkyInputs`` of one generated state (aerosols off:
    their fields zero)."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import AllSkyInputs
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    s = state
    gas = GasConcs.empty().set_vmr("h2o", s["h2o"]).set_vmr("o3", s["o3"])
    for name, v in s["gases"].items():
        gas = gas.set_vmr(name, v)
    zero = torch.zeros_like(s["tlay"])
    return AllSkyInputs(
        play=s["play"], plev=s["plev"], tlay=s["tlay"], tlev=s["tlev"],
        tsfc=s["tsfc"], gas_concs=gas.to(dtype=torch.float32,
                                         device=s["play"].device),
        lwp=s["lwp"], iwp=s["iwp"], rel=s["rel"], dei=s["dei"],
        aero_type=zero.to(torch.int32), aero_size=zero, aero_mass=zero,
        relhum=zero, sfc_emis=s["sfc_emis"], sfc_alb=s["sfc_alb"],
        mu0=s["mu0"])


def with_leaves(inputs, names):
    """``inputs`` with the fields ``names`` (``h2o``: the water vapour
    vmr) replaced by fresh leaves that require grad; returns (inputs,
    {name: leaf})."""
    ncol, nlay = inputs.play.shape
    leaves = {}
    for k in names:
        src = (inputs.gas_concs.get_vmr("h2o", ncol, nlay) if k == "h2o"
               else getattr(inputs, k))
        leaves[k] = src.detach().clone().requires_grad_()
    fields = {k: v for k, v in leaves.items() if k != "h2o"}
    if "h2o" in leaves:
        fields["gas_concs"] = inputs.gas_concs.set_vmr("h2o", leaves["h2o"])
    return inputs._replace(**fields), leaves


def rfmip_data(state: dict, config: dict):
    """The port's ``RFMIPData`` of one generated state: numpy fields and a
    gas store of CPU tensors, as the driver takes them (it moves them to
    the card once, at its first call)."""
    from rte_rrtmgp_tpu_torch.drivers.rfmip import RFMIPData
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    np32 = lambda t: t.detach().to("cpu", torch.float32).numpy()
    gas = GasConcs.empty()
    for name, v in state["gases"].items():
        gas = gas.set_vmr(name, v.detach().to("cpu", torch.float32))
    return RFMIPData(
        nsite=config["nsite"], nexp=config["nexp"],
        **{k: np32(state[k]) for k in ("play", "plev", "tlay", "tlev",
                                        "sfc_t", "sfc_emis", "sfc_alb",
                                        "tsi", "sza")},
        gas_concs=gas)
