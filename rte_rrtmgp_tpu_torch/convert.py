"""Carry state across from the JAX package: its ``KDist`` and
``CloudOpticsRRTMGP`` become the port's objects holding the very same
tables, so one test can run both packages on identical data.

The JAX objects are read only through their fields, as numpy arrays
(``np.asarray``); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.rrtmgp.cloud_optics import CloudOpticsRRTMGP
from .models.rrtmgp.kdist import KDist, MinorSet
from .spectral import SpectralGrid

__all__ = ["kdist_from_jax", "cloud_optics_from_jax"]


def _grid(g) -> SpectralGrid:
    return SpectralGrid(band_lims_wvn=tuple(g.band_lims_wvn),
                        band_lims_gpt=tuple(g.band_lims_gpt))


def _tensor(x, dtype, device):
    if x is None:
        return None
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def kdist_from_jax(kd, *, dtype=torch.float32, device="cpu") -> KDist:
    """The port's KDist with the tables and metadata of a JAX KDist."""
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
        solar_source=t(kd.solar_source))


def cloud_optics_from_jax(cld, *, dtype=torch.float32,
                          device="cpu") -> CloudOpticsRRTMGP:
    """The port's CloudOpticsRRTMGP with the tables of a JAX one (both
    store the ice tables roughness-major)."""
    t = lambda x: _tensor(x, dtype, device)
    return CloudOpticsRRTMGP(
        grid=_grid(cld.grid), radliq_lwr=float(cld.radliq_lwr),
        radliq_upr=float(cld.radliq_upr), diamice_lwr=float(cld.diamice_lwr),
        diamice_upr=float(cld.diamice_upr),
        extliq=t(cld.extliq), ssaliq=t(cld.ssaliq), asyliq=t(cld.asyliq),
        extice=t(cld.extice), ssaice=t(cld.ssaice), asyice=t(cld.asyice),
        icergh=int(cld.icergh))
