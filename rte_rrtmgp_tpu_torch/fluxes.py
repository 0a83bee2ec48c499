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

__all__ = ["Fluxes", "sum_broadband", "net_broadband", "sum_bands",
           "sum_byband", "net_byband"]


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


def sum_bands(spectral_flux: torch.Tensor, gpt2band,
              nband: int) -> torch.Tensor:
    """(..., ngpt) -> (..., nband): the sums over each band's g-points,
    band b's g-points those with gpt2band == b (0-based)."""
    ngpt = spectral_flux.shape[-1]
    m = torch.zeros((ngpt, nband), dtype=spectral_flux.dtype,
                    device=spectral_flux.device)
    band = torch.as_tensor(gpt2band, device=spectral_flux.device).long()
    m[torch.arange(ngpt, device=m.device), band] = 1.0
    return spectral_flux @ m


def sum_byband(spectral_flux: torch.Tensor,
               grid: SpectralGrid) -> torch.Tensor:
    """Per-band sums (reference ``sum_byband``, mo_fluxes_byband.F90:
    159-190): (..., ngpt) -> (..., nband)."""
    return sum_bands(spectral_flux, grid.gpt2band, grid.nband)


def net_byband(spectral_dn: torch.Tensor, spectral_up: torch.Tensor,
               grid: SpectralGrid) -> torch.Tensor:
    """Per-band net flux (reference ``net_byband_full``)."""
    return sum_byband(spectral_dn - spectral_up, grid)
