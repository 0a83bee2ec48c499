"""The broadband flux container and the spectral reductions.

Counterpart of ``rte_rrtmgp_tpu.fluxes`` (reference ``ty_fluxes_broadband``,
rte/kernels/mo_fluxes_broadband_kernels.F90, and the by-band extension
rte/extensions/mo_fluxes_byband.F90): reductions over the g-point axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .spectral import SpectralGrid

__all__ = ["Fluxes", "sum_broadband", "net_broadband", "sum_byband",
           "net_byband"]


@dataclasses.dataclass(frozen=True)
class Fluxes:
    flux_up: torch.Tensor                       # (ncol, nlev)
    flux_dn: torch.Tensor                       # (ncol, nlev)
    flux_net: torch.Tensor                      # (ncol, nlev) = dn - up
    flux_dn_dir: Optional[torch.Tensor] = None  # (ncol, nlev), SW only
    flux_up_jac: Optional[torch.Tensor] = None  # (ncol, nlev), LW Jacobian


def sum_broadband(spectral_flux: torch.Tensor) -> torch.Tensor:
    """g-point sum (reference ``sum_broadband``, :32-57)."""
    return spectral_flux.sum(-1)


def net_broadband(spectral_dn: torch.Tensor,
                  spectral_up: torch.Tensor) -> torch.Tensor:
    """down - up, summed over g-points (reference ``net_broadband_full``)."""
    return (spectral_dn - spectral_up).sum(-1)


def _band_matrix(grid: SpectralGrid, dtype, device) -> torch.Tensor:
    """One-hot (ngpt, nband) projection."""
    m = torch.zeros((grid.ngpt, grid.nband), dtype=dtype, device=device)
    m[torch.arange(grid.ngpt), torch.as_tensor(grid.gpt2band).long()] = 1.0
    return m


def sum_byband(spectral_flux: torch.Tensor,
               grid: SpectralGrid) -> torch.Tensor:
    """Per-band sums (reference ``sum_byband``, mo_fluxes_byband.F90:
    159-190): (..., ngpt) -> (..., nband)."""
    return spectral_flux @ _band_matrix(grid, spectral_flux.dtype,
                                        spectral_flux.device)


def net_byband(spectral_dn: torch.Tensor, spectral_up: torch.Tensor,
               grid: SpectralGrid) -> torch.Tensor:
    """Per-band net flux (reference ``net_byband_full``)."""
    return sum_byband(spectral_dn - spectral_up, grid)
