"""The all-sky problem and its forward step on tensors.

Counterpart of ``rte_rrtmgp_tpu.drivers.allsky`` (reference
examples/all-sky/rrtmgp_allsky.F90), three ways, each with clouds and
aerosols on or off (``use_clouds``, ``use_aerosols``), the fused and
public-API branches with broadband or by-band fluxes (``byband``):

  * the fused branch (``allsky_step_lw/sw``): per step, cloud optics
    (``ops/kernels/cloud_props``) and aerosol optics
    (``ops/kernels/aerosol_props``, which folds the clouds' increment into
    the aerosols' in the same launch), then the fused LW
    kernel with the absorption-only increment, then the fused SW kernel
    with the delta-scaled increment. :func:`build_allsky_step` is the
    counterpart of the JAX package's ``__graft_entry__._build``;
  * the staged lane-layout branch (``allsky_staged_lw/sw``), the JAX
    driver's non-fused lane branch (drivers/allsky.py:221-262,
    :321-372): ``gas_optics_lw/sw_lanes``, the increments by band, and
    the lane solvers (``ops/kernels/solver_lanes``), the Planck sources
    or the Rayleigh/cloud combine inside the solver for a banded
    k-distribution;
  * the public API (``allsky_api_lw/sw``), the JAX driver's generic
    branch (drivers/allsky.py:393-411, :431-446): ``gas_optics_lw/sw``,
    ``cloud_optics``, ``aerosol_optics``, ``increment`` and
    ``rte_lw/rte_sw``, as a user of the library composes them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants, trace
from ..config import check_dtype, resolve_device
from ..fluxes import Fluxes
from ..gas_concs import GasConcs
from ..models.rrtmgp.aerosol_optics import MERRA_AERO_DUST, MERRA_AERO_SULF
from ..models.rrtmgp.gas_optics import GasOpticsRRTMGP
from ..optical_props import delta_scale, increment
from ..ops.kernels.aerosol_props import delta_scaled_band
from ..ops.kernels.fused_lw import LWFusedInputs, lw_fused, reverse_axes
from ..ops.kernels.fused_sw import SWFusedInputs, sw_fused
from ..ops.kernels.solver_lanes import (increment_2str_bybnd,
                                        lw_noscat_lanes,
                                        lw_noscat_lanes_pfrac,
                                        sw_2stream_lanes,
                                        sw_2stream_lanes_combined)
from ..ops.solver_lw import GAUSS_DS, GAUSS_WTS
from ..rte import rte_lw, rte_sw
from ..utils.profiles import allsky_profiles
from ..utils.synthetic import (synthetic_aerosol_optics,
                               synthetic_cloud_optics, synthetic_kdist)

__all__ = ["AllSkyInputs", "make_allsky_inputs", "get_relhum",
           "allsky_lw_inputs", "allsky_sw_inputs", "allsky_step_lw",
           "allsky_step_sw", "allsky_staged_lw", "allsky_staged_sw",
           "allsky_api_lw", "allsky_api_sw", "AllSkyProblem",
           "build_allsky", "build_allsky_step"]


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
                       dtype=torch.float32, device=None) -> AllSkyInputs:
    """Build the all-sky problem (reference rrtmgp_allsky.F90: analytic
    profiles :496-587, clouds :590-662, aerosols :666-739, emissivity
    0.98 / albedo 0.06 / mu0 0.86) in numpy, then move it to ``device``
    (default: the CUDA device)."""
    check_dtype(dtype)
    device = resolve_device(device)
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


def _absorption_lanes(inputs: AllSkyInputs, cloud_optics, use_clouds,
                      aerosol_optics, use_aerosols):
    """The LW increment by band, (nbnd, nlay, ncol) or None: the
    absorption (tau - tau*ssa) of the clouds plus that of the aerosols
    (reference increment_1scalar_by_2stream; JAX drivers/allsky.py:
    122-128, :231-245), the aerosols' added inside their lookup's
    launch."""
    i = inputs
    cloud = None
    if use_clouds:
        if cloud_optics is None:
            raise ValueError("allsky LW: use_clouds needs cloud_optics")
        cloud = cloud_optics.cloud_optics_lanes(i.lwp, i.iwp, i.rel, i.dei)
    if use_aerosols:
        if aerosol_optics is None:
            raise ValueError("allsky LW: use_aerosols needs aerosol_optics")
        return aerosol_optics.absorption_lanes(
            i.aero_type, i.aero_size, i.aero_mass, i.relhum, cloud=cloud)
    return None if cloud is None else cloud[0] - cloud[1]


def _scattering_lanes(inputs: AllSkyInputs, cloud_optics, use_clouds,
                      aerosol_optics, use_aerosols):
    """The SW increment by band, delta-scaled (tau, ssa, g) each (nbnd,
    nlay, ncol), or None: the clouds' combined with the aerosols' (JAX
    drivers/allsky.py:288-301, :327-341), inside the aerosols' lookup's
    launch where there are aerosols."""
    i = inputs
    cloud = None
    if use_clouds:
        if cloud_optics is None:
            raise ValueError("allsky SW: use_clouds needs cloud_optics")
        cloud = cloud_optics.cloud_optics_lanes(i.lwp, i.iwp, i.rel, i.dei)
    if use_aerosols:
        if aerosol_optics is None:
            raise ValueError("allsky SW: use_aerosols needs aerosol_optics")
        return aerosol_optics.scattering_lanes(
            i.aero_type, i.aero_size, i.aero_mass, i.relhum, cloud=cloud)
    return None if cloud is None else delta_scaled_band(*cloud)


def allsky_lw_inputs(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                     cloud_optics=None, use_clouds=True, aerosol_optics=None,
                     use_aerosols=False, byband=False) -> LWFusedInputs:
    """The fused LW kernel's inputs for one all-sky step: the
    absorption-only by-band increment of clouds and aerosols and the
    descriptor prep; no incident flux."""
    cld_abs = _absorption_lanes(inputs, cloud_optics, use_clouds,
                                aerosol_optics, use_aerosols)
    ncol = inputs.play.shape[0]
    emis = inputs.sfc_emis[:, 0][None, :].expand(gas_optics.ngpt, ncol)
    return gas_optics.lw_fused_inputs(
        inputs.play, inputs.plev, inputs.tlay, inputs.tsfc, inputs.gas_concs,
        sfc_emis=emis, tlev=inputs.tlev,
        cloud_tau_abs=None if cld_abs is None else cld_abs.contiguous(),
        ds=GAUSS_DS[0][0], weight=GAUSS_WTS[0][0], byband=byband)


def allsky_sw_inputs(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                     cloud_optics=None, use_clouds=True, aerosol_optics=None,
                     use_aerosols=False, byband=False) -> SWFusedInputs:
    """The fused SW kernel's inputs for one all-sky step: the
    delta-scaled by-band increment of clouds and aerosols and the
    descriptor prep; the solar source at the top, no diffuse flux."""
    cloud = _scattering_lanes(inputs, cloud_optics, use_clouds,
                              aerosol_optics, use_aerosols)
    ncol, nlay = inputs.play.shape
    mu0 = inputs.mu0[None, :].expand(nlay, ncol)
    alb = inputs.sfc_alb[:, 0][None, :].expand(gas_optics.ngpt, ncol)
    return gas_optics.sw_fused_inputs(
        inputs.play, inputs.plev, inputs.tlay, inputs.gas_concs, mu0=mu0,
        sfc_alb_dir=alb, sfc_alb_dif=alb, cloud=cloud, byband=byband)


@trace.spanned("allsky.lw")
def allsky_step_lw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                   cloud_optics=None, use_clouds=True, aerosol_optics=None,
                   use_aerosols=False, byband=False) -> Fluxes:
    """One LW all-sky step (reference timed loop :368-380): cloud and
    aerosol optics, then gas optics + no-scattering solve in one fused
    kernel. Broadband (ncol, nlay+1) fluxes, or with ``byband`` per-band
    sums (ncol, nlay+1, nband) (uniform bands only, as in the JAX
    package)."""
    up, dn = (reverse_axes(f) for f in lw_fused(allsky_lw_inputs(
        inputs, gas_optics, cloud_optics=cloud_optics, use_clouds=use_clouds,
        aerosol_optics=aerosol_optics, use_aerosols=use_aerosols,
        byband=byband)))
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up)


@trace.spanned("allsky.sw")
def allsky_step_sw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                   cloud_optics=None, use_clouds=True, aerosol_optics=None,
                   use_aerosols=False, byband=False) -> Fluxes:
    """One SW all-sky step (reference :388-404): cloud and aerosol
    optics, then gas optics + Rayleigh + two-stream solve in one fused
    kernel. Broadband or, with ``byband``, per-band fluxes, as
    :func:`allsky_step_lw`."""
    up, dn, fdir = (reverse_axes(f) for f in sw_fused(allsky_sw_inputs(
        inputs, gas_optics, cloud_optics=cloud_optics, use_clouds=use_clouds,
        aerosol_optics=aerosol_optics, use_aerosols=use_aerosols,
        byband=byband)))
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up, flux_dn_dir=fdir)


def _banded(gas_optics: GasOpticsRRTMGP) -> bool:
    """The JAX package's choice between its two staged kernel pairs
    (drivers/allsky.py:179-184): uniform band width, a multiple of 8. The
    8 is the TPU kernels' g-point block; the port's solvers take any band
    widths (through gpt2band), and keep the rule only so that both
    packages pick the same solver for the same k-distribution."""
    lims = np.asarray(gas_optics.grid.band_lims_gpt)
    widths = lims[:, 1] - lims[:, 0] + 1
    return bool((widths == widths[0]).all() and widths[0] % 8 == 0)


def allsky_staged_lw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                     cloud_optics=None, use_clouds=True, aerosol_optics=None,
                     use_aerosols=False) -> Fluxes:
    """One LW all-sky step through the staged lane-layout branch (JAX
    drivers/allsky.py:221-262): gas optics in the lane layout, the
    absorption increment by band, then one lane solver: with a banded
    k-distribution the one that forms the Planck sources and adds the
    increment itself (``lw_noscat_lanes_pfrac``), else the plain one
    after both are done here (``lw_noscat_lanes``). No incident flux."""
    i = inputs
    banded = _banded(gas_optics)
    out = gas_optics.gas_optics_lw_lanes(i.play, i.plev, i.tlay, i.tsfc,
                                         i.gas_concs, tlev=i.tlev,
                                         banded_planck=banded)
    cld_abs = _absorption_lanes(i, cloud_optics, use_clouds, aerosol_optics,
                                use_aerosols)
    tau = out[0]
    ngpt, _, ncol = tau.shape
    emis = i.sfc_emis[:, 0][None, :].expand(ngpt, ncol)
    inc = tau.new_zeros(()).expand(ngpt, ncol)
    kw = dict(ds=GAUSS_DS[0][0], weight=GAUSS_WTS[0][0])
    if banded:
        _, pfrac, (pb_sfc, pb_lay, pb_lev) = out
        up, dn = lw_noscat_lanes_pfrac(
            tau, pfrac, pb_lay, pb_lev, pb_sfc, emis, inc,
            gpt2band=gas_optics.gpt2band, cloud_tau_abs=cld_abs, **kw)
    else:
        sfc_src, lay_src, lev_src, _ = out[1]
        if cld_abs is not None:
            tau = tau + cld_abs[gas_optics.gpt2band.long()]
        up, dn, _ = lw_noscat_lanes(tau, lay_src, lev_src, emis, sfc_src,
                                    inc, **kw)
    up, dn = up.T, dn.T
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up)


def allsky_staged_sw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                     cloud_optics=None, use_clouds=True, aerosol_optics=None,
                     use_aerosols=False) -> Fluxes:
    """One SW all-sky step through the staged lane-layout branch (JAX
    drivers/allsky.py:321-372): gas optics in the lane layout, the
    delta-scaled increment by band, then one lane solver: with a banded
    k-distribution the one that does the Rayleigh combine and the
    increment itself (``sw_2stream_lanes_combined``), else the plain one
    after both are done here (``sw_2stream_lanes``)."""
    i = inputs
    banded = _banded(gas_optics)
    tau, ssa_or_ray, toa = gas_optics.gas_optics_sw_lanes(
        i.play, i.plev, i.tlay, i.gas_concs, split_rayleigh=banded)
    cloud = _scattering_lanes(i, cloud_optics, use_clouds, aerosol_optics,
                              use_aerosols)
    ngpt, nlay, ncol = tau.shape
    mu0 = i.mu0[None, :].expand(nlay, ncol)
    alb = i.sfc_alb[:, 0][None, :].expand(ngpt, ncol)
    if banded:
        up, dn, fdir = sw_2stream_lanes_combined(
            tau, ssa_or_ray, cloud, mu0, alb, alb, toa,
            gpt2band=gas_optics.gpt2band)
    else:
        # JAX drivers/allsky.py:352-367, the dtype's tiny
        tau, ssa, g = increment_2str_bybnd(tau, ssa_or_ray, cloud,
                                           gas_optics.gpt2band,
                                           torch.finfo(tau.dtype).tiny)
        up, dn, fdir = sw_2stream_lanes(tau, ssa, g, mu0, alb, alb, toa)
    up, dn, fdir = up.T, dn.T, fdir.T
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up, flux_dn_dir=fdir)


def _clouds(inputs: AllSkyInputs, gas_optics, cloud_optics, **kw):
    """The clouds' optical properties: the cloud optics', or without one
    the gas optics' gray clouds from the water paths in kg/m2 (SSM; JAX
    drivers/allsky.py:397-404, :436-439)."""
    i = inputs
    if cloud_optics is None:
        return gas_optics.cloud_optics(i.lwp * 1e-3, i.iwp * 1e-3, **kw)
    return cloud_optics.cloud_optics(i.lwp, i.iwp, i.rel, i.dei, **kw)


@trace.spanned("allsky_api.lw")
def allsky_api_lw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                  cloud_optics=None, use_clouds=True, aerosol_optics=None,
                  use_aerosols=False, byband=False) -> Fluxes:
    """One LW all-sky step through the public API (the JAX driver's
    generic branch, drivers/allsky.py:393-411): gas optics and Planck
    sources, the absorption-only cloud and aerosol increments (without
    ``cloud_optics``, the gas optics' gray clouds: SSM), then ``rte_lw``
    (``byband``: per-band sums)."""
    i = inputs
    props, sources = gas_optics.gas_optics_lw(
        i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
        top_at_1=True)
    if use_clouds:
        props = increment(props, _clouds(i, gas_optics, cloud_optics,
                                         scattering=False))
    if use_aerosols:
        props = increment(props, aerosol_optics.aerosol_optics(
            i.aero_type, i.aero_size, i.aero_mass, i.relhum,
            scattering=False))
    return rte_lw(props, sources, i.sfc_emis, byband=byband)


@trace.spanned("allsky_api.sw")
def allsky_api_sw(inputs: AllSkyInputs, gas_optics: GasOpticsRRTMGP, *,
                  cloud_optics=None, use_clouds=True, aerosol_optics=None,
                  use_aerosols=False, byband=False) -> Fluxes:
    """One SW all-sky step through the public API (drivers/allsky.py:
    431-446): gas optics, the delta-scaled cloud and aerosol increments
    (without ``cloud_optics``, the gas optics' gray clouds: SSM), then
    ``rte_sw`` (``byband``: per-band sums)."""
    i = inputs
    props, toa = gas_optics.gas_optics_sw(i.play, i.plev, i.tlay,
                                          i.gas_concs, top_at_1=True)
    if use_clouds:
        props = increment(props, delta_scale(_clouds(i, gas_optics,
                                                     cloud_optics)))
    if use_aerosols:
        props = increment(props, delta_scale(aerosol_optics.aerosol_optics(
            i.aero_type, i.aero_size, i.aero_mass, i.relhum)))
    return rte_sw(props, i.mu0, toa, i.sfc_alb, i.sfc_alb, byband=byband)


class AllSkyProblem(NamedTuple):
    gas_lw: GasOpticsRRTMGP
    gas_sw: GasOpticsRRTMGP
    cld_lw: object           # CloudOpticsRRTMGP on the LW bands
    cld_sw: object           # CloudOpticsRRTMGP on the SW bands
    aer_lw: object           # AerosolOpticsMERRA on the LW bands, or None
    aer_sw: object           # AerosolOpticsMERRA on the SW bands, or None
    inputs: AllSkyInputs


def build_allsky(ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp,
                 npres, *, device, use_aerosols=False,
                 dtype=torch.float32) -> AllSkyProblem:
    """Synthetic LW and SW k-distributions, cloud tables and, with
    ``use_aerosols``, aerosol tables (seed 0, as the JAX package's
    ``_build``), and the all-sky inputs, on ``device``."""
    check_dtype(dtype)
    kw = dict(ntemp=ntemp, npres=npres, dtype=dtype, device=device)
    gas_lw = GasOpticsRRTMGP(synthetic_kdist(sw=False, ngpt=ngpt_lw,
                                             nbnd=nbnd_lw, **kw))
    gas_sw = GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=ngpt_sw,
                                             nbnd=nbnd_sw, **kw))
    tab = dict(dtype=dtype, device=device)
    per_band = lambda make: tuple(
        make(nbnd=n, band_lims_wvn=g.grid.band_lims_wvn_array, **tab)
        for n, g in ((nbnd_lw, gas_lw), (nbnd_sw, gas_sw)))
    cld_lw, cld_sw = per_band(synthetic_cloud_optics)
    aer_lw, aer_sw = (per_band(synthetic_aerosol_optics) if use_aerosols
                      else (None, None))
    inputs = make_allsky_inputs(ncol, nlay, cloud_optics=cld_lw, dtype=dtype,
                                device=device)
    return AllSkyProblem(gas_lw, gas_sw, cld_lw, cld_sw, aer_lw, aer_sw,
                         inputs)


def build_allsky_step(ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp,
                      npres, *, device, use_clouds=True, use_aerosols=False,
                      dtype=torch.float32):
    """(step, inputs) for the all-sky problem of :func:`build_allsky`
    through the fused branch, as the JAX package's ``_build``.
    ``step(inputs)`` returns (lw_up, lw_dn, sw_up, sw_dn, sw_dn_dir), each
    (ncol, nlay+1)."""
    p = build_allsky(ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp,
                     npres, device=device, use_aerosols=use_aerosols,
                     dtype=dtype)
    opts = dict(use_clouds=use_clouds, use_aerosols=use_aerosols)

    def step(inputs):
        lw = allsky_step_lw(inputs, p.gas_lw, cloud_optics=p.cld_lw,
                            aerosol_optics=p.aer_lw, **opts)
        sw = allsky_step_sw(inputs, p.gas_sw, cloud_optics=p.cld_sw,
                            aerosol_optics=p.aer_sw, **opts)
        return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                sw.flux_dn_dir)

    return step, p.inputs
