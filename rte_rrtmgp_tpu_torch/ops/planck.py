"""Analytic Planck source functions on tensors.

Counterpart of ``rte_rrtmgp_tpu.ops.planck`` (reference
rte/kernels/mo_gas_optics_utils.F90:36-95, ``B_nu`` and
``compute_Planck_source``): spectral radiance at wavenumber nu [cm^-1]
integrated over a band width dnu, in W/m2/sr, which the LW solvers turn
into flux through pi times the quadrature weight.
"""
from __future__ import annotations

import torch

from ..constants import boltzmann_k, lightspeed, planck_h

__all__ = ["b_nu", "planck_source"]


def b_nu(t, nu):
    """Planck radiance per cm^-1 at temperature ``t`` [K] and wavenumber
    ``nu`` [cm^-1] (reference B_nu, mo_gas_optics_utils.F90:36-41)."""
    nu_m = nu * 100.0  # cm^-1 -> m^-1
    return (100.0 * 2.0 * planck_h * (nu_m ** 3) * lightspeed ** 2
            / (torch.exp((planck_h * lightspeed * nu_m) / (boltzmann_k * t))
               - 1.0))


def planck_source(t, nus, dnus):
    """Band-integrated Planck source B_nu(T, nu) * dnu: t (...) [K],
    nus and dnus (nnu,) tensors; returns (..., nnu) (reference
    compute_Planck_source, mo_gas_optics_utils.F90:43-95)."""
    t = torch.as_tensor(t)
    return b_nu(t[..., None], nus) * dnus
