"""Carry state across from the JAX package: its ``KDist``,
``CloudOpticsRRTMGP``, ``AerosolOpticsMERRA``, ``OpticsSSM`` and
``GasConcs`` become the port's objects holding the very same tables and
values, so one test can run both packages on identical data.

The JAX objects are read only through their fields, as numpy arrays
(``np.asarray``); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .gas_concs import GasConcs
from .models.rrtmgp.aerosol_optics import AerosolOpticsMERRA
from .models.rrtmgp.cloud_optics import CloudOpticsRRTMGP
from .models.rrtmgp.kdist import KDist, MinorSet
from .models.ssm import OpticsSSM
from .spectral import SpectralGrid

__all__ = ["kdist_from_jax", "cloud_optics_from_jax",
           "aerosol_optics_from_jax", "ssm_from_jax", "gas_concs_from_jax"]


def _grid(g) -> SpectralGrid:
    return SpectralGrid(band_lims_wvn=tuple(g.band_lims_wvn),
                        band_lims_gpt=tuple(g.band_lims_gpt))


def _tensor(x, dtype, device):
    if x is None:
        return None
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def kdist_from_jax(kd, *, dtype=torch.float32, device=None) -> KDist:
    """The port's KDist with the tables and metadata of a JAX KDist, on
    ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    t = lambda x: _tensor(x, dtype, device)
    minor = lambda m: MinorSet(**{f: getattr(m, f) for f in (
        "gas_names", "limits_gpt", "scales_with_density",
        "scale_by_complement", "idx_minor", "idx_minor_scaling",
        "kminor_start", "flavor")})
    return KDist(
        grid=_grid(kd.grid), gas_names=tuple(kd.gas_names),
        flavor=np.asarray(kd.flavor), gpoint_flavor=np.asarray(kd.gpoint_flavor),
        press_ref_log=np.asarray(kd.press_ref_log),
        temp_ref=np.asarray(kd.temp_ref),
        press_ref_trop_log=float(kd.press_ref_trop_log),
        press_ref_log_delta=float(kd.press_ref_log_delta),
        temp_ref_min=float(kd.temp_ref_min),
        temp_ref_delta=float(kd.temp_ref_delta),
        temp_ref_max=float(kd.temp_ref_max),
        vmr_ref=np.asarray(kd.vmr_ref), minor_lower=minor(kd.minor_lower),
        minor_upper=minor(kd.minor_upper), neta=int(kd.neta),
        kmajor=t(kd.kmajor), kminor_lower=t(kd.kminor_lower),
        kminor_upper=t(kd.kminor_upper), krayl=t(kd.krayl),
        planck_frac=t(kd.planck_frac), totplnk=t(kd.totplnk),
        totplnk_delta=float(kd.totplnk_delta),
        solar_source=t(kd.solar_source),
        optimal_angle_fit=(None if kd.optimal_angle_fit is None
                           else np.asarray(kd.optimal_angle_fit)))


def cloud_optics_from_jax(cld, *, dtype=torch.float32,
                          device=None) -> CloudOpticsRRTMGP:
    """The port's CloudOpticsRRTMGP with the tables of a JAX one (both
    store the ice tables roughness-major), on ``device`` (default: the
    CUDA device)."""
    device = resolve_device(device)
    t = lambda x: _tensor(x, dtype, device)
    return CloudOpticsRRTMGP(
        grid=_grid(cld.grid), radliq_lwr=float(cld.radliq_lwr),
        radliq_upr=float(cld.radliq_upr), diamice_lwr=float(cld.diamice_lwr),
        diamice_upr=float(cld.diamice_upr),
        extliq=t(cld.extliq), ssaliq=t(cld.ssaliq), asyliq=t(cld.asyliq),
        extice=t(cld.extice), ssaice=t(cld.ssaice), asyice=t(cld.asyice),
        icergh=int(cld.icergh))


def aerosol_optics_from_jax(aer, *, dtype=torch.float32,
                            device=None) -> AerosolOpticsMERRA:
    """The port's AerosolOpticsMERRA with the tables of a JAX one (both
    store them value-major), on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    t = lambda x: _tensor(x, dtype, device)
    return AerosolOpticsMERRA(
        grid=_grid(aer.grid), bin_lims=np.array(aer.bin_lims, np.float64),
        aero_rh=np.array(aer.aero_rh, np.float64),
        **{f: t(getattr(aer, f)) for f in (
            "dust_tbl", "salt_tbl", "sulf_tbl", "bcar_tbl", "bcar_rh_tbl",
            "ocar_tbl", "ocar_rh_tbl")})


def ssm_from_jax(ssm, *, device=None) -> OpticsSSM:
    """The port's OpticsSSM with the configuration and tables of a JAX
    one (float64, as both compute them), on ``device`` (default: the CUDA
    device)."""
    device = resolve_device(device)
    t = lambda x: _tensor(x, torch.float64, device)
    return OpticsSSM(
        grid=_grid(ssm.grid), gas_names=tuple(ssm.gas_names),
        mol_weights=np.array(ssm.mol_weights, np.float64),
        absorption_coeffs=t(ssm.absorption_coeffs), nus=t(ssm.nus),
        dnus=t(ssm.dnus), toa_src=t(ssm.toa_src),
        **{f: float(getattr(ssm, f)) for f in (
            "tstar", "tsi", "pref", "m_dry", "kappa_cld", "g_cld",
            "ssa_cld")})


def gas_concs_from_jax(gas_concs, *, device=None) -> GasConcs:
    """The port's GasConcs with the names and values of a JAX one, each
    value in its own dtype, on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    return GasConcs(names=tuple(gas_concs.names), values=tuple(
        torch.as_tensor(np.array(v), device=device)
        for v in gas_concs.values))
