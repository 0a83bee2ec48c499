"""The all-sky problem and its forward step on tensors.

Counterpart of ``rte_rrtmgp_tpu.drivers.allsky`` (reference
examples/all-sky/rrtmgp_allsky.F90) on its fused branch: per step,
cloud optics (``ops/kernels/cloud_props``), then the fused LW kernel with
the absorption-only cloud increment, then the fused SW kernel with the
delta-scaled cloud increment. :func:`build_allsky_step` is the
counterpart of the JAX package's ``__graft_entry__._build``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from ..config import check_dtype
from ..fluxes import Fluxes
from ..gas_concs import GasConcs
from ..models.rrtmgp.gas_optics import GasOpticsRRTMGP
from ..ops.kernels.fused_lw import LWFusedInputs, lw_fused
from ..ops.kernels.fused_sw import SWFusedInputs, sw_fused
from ..ops.solver_lw import GAUSS_DS, GAUSS_WTS
from ..utils.profiles import allsky_profiles
from ..utils.synthetic import synthetic_cloud_optics, synthetic_kdist

__all__ = ["AllSkyInputs", "make_allsky_inputs", "get_relhum",
           "allsky_lw_inputs", "allsky_sw_inputs", "allsky_step_lw",
           "allsky_step_sw", "AllSkyProblem", "build_allsky",
           "build_allsky_step"]

# MERRA aerosol type codes used by the all-sky inputs (reference
# mo_aerosol_optics_rrtmgp_merra.F90)
MERRA_AERO_DUST = 1
MERRA_AERO_SULF = 3


class AllSkyInputs(NamedTuple):
    play: torch.Tensor       # (ncol, nlay)
    plev: torch.Tensor       # (ncol, nlay+1)
    tlay: torch.Tensor
    tlev: torch.Tensor
    tsfc: torch.Tensor       # (ncol,)
    gas_concs: GasConcs
    lwp: torch.Tensor        # (ncol, nlay) cloud liquid water path [g/m2]
    iwp: torch.Tensor
    rel: torch.Tensor        # liquid effective radius [microns]
    dei: torch.Tensor        # ice effective diameter [microns]
    aero_type: torch.Tensor  # (ncol, nlay) int32
    aero_size: torch.Tensor
    aero_mass: torch.Tensor
    relhum: torch.Tensor
    sfc_emis: torch.Tensor   # (ncol, 1)
    sfc_alb: torch.Tensor    # (ncol, 1)
    mu0: torch.Tensor        # (ncol,)


def get_relhum(play, tlay, vmr_h2o):
    """Layer relative humidity [0-1] from pressure, temperature and vmr
    (reference rrtmgp_allsky.F90:744-786 get_relhum), on numpy arrays."""
    mwd = constants.m_h2o / constants.m_dry
    t_ref = 273.16
    mmr = vmr_h2o * mwd
    q = np.maximum(1.0e-7, mmr / (1.0 + mmr))
    es = np.exp(17.67 * (tlay - t_ref) / (tlay - 29.65))
    return 0.01 * (0.263 * play * q) / es


def make_allsky_inputs(ncol: int, nlay: int, *, cloud_optics=None,
                       dtype=torch.float32, device="cpu") -> AllSkyInputs:
    """Build the all-sky problem (reference rrtmgp_allsky.F90: analytic
    profiles :496-587, clouds :590-662, aerosols :666-739, emissivity
    0.98 / albedo 0.06 / mu0 0.86) in numpy, then move it to ``device``."""
    check_dtype(dtype)
    play, plev, tlay, tlev, gas = allsky_profiles(ncol, nlay)

    # clouds: troposphere (100-900 hPa), 2 of every 3 columns
    icol = np.arange(ncol)[:, None] + 1                    # 1-based like ref
    cloud_mask = (play > 100.0e2) & (play < 900.0e2) & ((icol % 3) != 0)
    lwp = np.where(cloud_mask & (tlay > 263.0), 10.0, 0.0)
    iwp = np.where(cloud_mask & (tlay < 273.0), 10.0, 0.0)
    if cloud_optics is not None:
        rel_val = 0.5 * (cloud_optics.radliq_lwr + cloud_optics.radliq_upr)
        dei_val = 0.5 * (cloud_optics.diamice_lwr + cloud_optics.diamice_upr)
    else:
        rel_val, dei_val = 10.0, 20.0
    rel = np.where(lwp > 0.0, rel_val, 0.0)
    dei = np.where(iwp > 0.0, dei_val, 0.0)

    # aerosols: sulfate 50-100 hPa, dust 700-900 hPa, odd columns (1-based)
    is_odd_col = (icol % 2) != 0
    is_sulf = (play > 50.0e2) & (play < 100.0e2) & is_odd_col
    is_dust = (play > 700.0e2) & (play < 900.0e2) & is_odd_col
    aero_type = np.where(is_sulf, MERRA_AERO_SULF,
                         np.where(is_dust, MERRA_AERO_DUST, 0))
    aero_size = np.where(is_sulf, 0.2, np.where(is_dust, 0.5, 0.0))
    aero_mass = np.where(is_sulf, 1.0e-6, np.where(is_dust, 3.0e-5, 0.0))
    vmr_h2o = gas.get_vmr("h2o", ncol, nlay).numpy()
    relhum = get_relhum(play, tlay, vmr_h2o)

    cast = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                     device=device)
    return AllSkyInputs(
        play=cast(play), plev=cast(plev), tlay=cast(tlay), tlev=cast(tlev),
        tsfc=cast(tlay[:, -1] * 0 + 300.0),
        gas_concs=gas.to(dtype=dtype, device=device),
        lwp=cast(lwp), iwp=cast(iwp), rel=cast(rel), dei=cast(dei),
        aero_type=torch.as_tensor(aero_type, dtype=torch.int32,
                                  device=device),
        aero_size=cast(aero_size), aero_mass=cast(aero_mass),
        relhum=cast(np.clip(relhum, 0.0, 1.0)),
        sfc_emis=cast(np.full((ncol, 1), 0.98)),
        sfc_alb=cast(np.full((ncol, 1), 0.06)),
        mu0=cast(np.full(ncol, 0.86)))


def _delta_scaled_band(t, ts, tsg):
    """(tau, tau*ssa, tau*ssa*g) by band -> delta-Eddington-scaled
    (tau, ssa, g) with f = g^2 (JAX drivers/allsky.py:131-144)."""
    finfo = torch.finfo(t.dtype)
    g = tsg / torch.clamp(ts, min=finfo.eps)
    ssa = ts / torch.clamp(t, min=finfo.eps)
    f = g * g
    wf = ssa * f
    return ((1.0 - wf) * t,
            torch.where(wf < 1.0, (ssa - wf)
                        / torch.clamp(1.0 - wf, min=finfo.tiny), 0.0),
            torch.where(f < 1.0, (g - f)
                        / torch.clamp(1.0 - f, min=finfo.tiny), 0.0))


def allsky_lw_inputs(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                     cloud_optics=None, use_clouds=True) -> LWFusedInputs:
    """The fused LW kernel's inputs for one all-sky step: the
    absorption-only by-band cloud increment (tau - tau*ssa, reference
    increment_1scalar_by_2stream) and the descriptor prep."""
    cld_abs = None
    if use_clouds:
        if cloud_optics is None:
            raise ValueError("allsky LW: use_clouds needs cloud_optics")
        t, ts, _ = cloud_optics.cloud_optics_lanes(
            inputs.lwp, inputs.iwp, inputs.rel, inputs.dei)
        cld_abs = (t - ts).contiguous()
    ncol = inputs.play.shape[0]
    emis = inputs.sfc_emis[:, 0][None, :].expand(gas_optics.ngpt, ncol)
    return gas_optics.lw_fused_inputs(
        inputs.play, inputs.plev, inputs.tlay, inputs.tsfc, inputs.gas_concs,
        sfc_emis=emis, tlev=inputs.tlev, cloud_tau_abs=cld_abs,
        ds=GAUSS_DS, weight=GAUSS_WTS)


def allsky_sw_inputs(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                     cloud_optics=None, use_clouds=True) -> SWFusedInputs:
    """The fused SW kernel's inputs for one all-sky step: the
    delta-scaled by-band cloud optics and the descriptor prep."""
    cloud = None
    if use_clouds:
        if cloud_optics is None:
            raise ValueError("allsky SW: use_clouds needs cloud_optics")
        cloud = _delta_scaled_band(*cloud_optics.cloud_optics_lanes(
            inputs.lwp, inputs.iwp, inputs.rel, inputs.dei))
    ncol, nlay = inputs.play.shape
    mu0 = inputs.mu0[None, :].expand(nlay, ncol)
    alb = inputs.sfc_alb[:, 0][None, :].expand(gas_optics.ngpt, ncol)
    return gas_optics.sw_fused_inputs(
        inputs.play, inputs.plev, inputs.tlay, inputs.gas_concs, mu0=mu0,
        sfc_alb_dir=alb, sfc_alb_dif=alb, cloud=cloud)


def allsky_step_lw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                   cloud_optics=None, use_clouds=True) -> Fluxes:
    """One LW all-sky step (reference timed loop :368-380): cloud optics,
    then gas optics + no-scattering solve in one fused kernel."""
    up, dn = lw_fused(allsky_lw_inputs(inputs, gas_optics,
                                       cloud_optics=cloud_optics,
                                       use_clouds=use_clouds))
    up, dn = up.T, dn.T
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up)


def allsky_step_sw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                   cloud_optics=None, use_clouds=True) -> Fluxes:
    """One SW all-sky step (reference :388-404): cloud optics, then gas
    optics + Rayleigh + two-stream solve in one fused kernel."""
    up, dn, fdir = sw_fused(allsky_sw_inputs(inputs, gas_optics,
                                             cloud_optics=cloud_optics,
                                             use_clouds=use_clouds))
    up, dn, fdir = up.T, dn.T, fdir.T
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up, flux_dn_dir=fdir)


class AllSkyProblem(NamedTuple):
    gas_lw: GasOpticsRRTMGP
    gas_sw: GasOpticsRRTMGP
    cld_lw: object           # CloudOpticsRRTMGP on the LW bands
    cld_sw: object           # CloudOpticsRRTMGP on the SW bands
    inputs: AllSkyInputs


def build_allsky(ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp,
                 npres, *, device, dtype=torch.float32) -> AllSkyProblem:
    """Synthetic LW and SW k-distributions and cloud tables (seed 0, as
    the JAX package's ``_build``) and the all-sky inputs, on ``device``."""
    check_dtype(dtype)
    kw = dict(ntemp=ntemp, npres=npres, dtype=dtype, device=device)
    gas_lw = GasOpticsRRTMGP(synthetic_kdist(sw=False, ngpt=ngpt_lw,
                                             nbnd=nbnd_lw, **kw))
    gas_sw = GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=ngpt_sw,
                                             nbnd=nbnd_sw, **kw))
    cld = dict(dtype=dtype, device=device)
    cld_lw = synthetic_cloud_optics(
        nbnd=nbnd_lw, band_lims_wvn=gas_lw.grid.band_lims_wvn_array, **cld)
    cld_sw = synthetic_cloud_optics(
        nbnd=nbnd_sw, band_lims_wvn=gas_sw.grid.band_lims_wvn_array, **cld)
    inputs = make_allsky_inputs(ncol, nlay, cloud_optics=cld_lw, dtype=dtype,
                                device=device)
    return AllSkyProblem(gas_lw, gas_sw, cld_lw, cld_sw, inputs)


def build_allsky_step(ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp,
                      npres, *, device, use_clouds=True,
                      dtype=torch.float32):
    """(step, inputs) for the all-sky problem of :func:`build_allsky`.
    ``step(inputs)`` returns (lw_up, lw_dn, sw_up, sw_dn, sw_dn_dir), each
    (ncol, nlay+1)."""
    p = build_allsky(ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp,
                     npres, device=device, dtype=dtype)

    def step(inputs):
        lw = allsky_step_lw(inputs, p.gas_lw, cloud_optics=p.cld_lw,
                            use_clouds=use_clouds)
        sw = allsky_step_sw(inputs, p.gas_sw, cloud_optics=p.cld_sw,
                            use_clouds=use_clouds)
        return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                sw.flux_dn_dir)

    return step, p.inputs
