"""Planck source-function container for longwave radiation.

Counterpart of ``rte_rrtmgp_tpu.sources`` (reference
``ty_source_func_lw``, rte/frontend/mo_source_functions.F90:30-49).
"""
from __future__ import annotations

import dataclasses

import torch

from .spectral import SpectralGrid

__all__ = ["SourcesLW", "subset_sources"]


@dataclasses.dataclass(frozen=True)
class SourcesLW:
    lay_source: torch.Tensor      # (ncol, nlay, ngpt)   at layer centers [W/m2]
    lev_source: torch.Tensor      # (ncol, nlay+1, ngpt) at layer edges [W/m2]
    sfc_source: torch.Tensor      # (ncol, ngpt)         surface [W/m2]
    sfc_source_jac: torch.Tensor  # (ncol, ngpt)         d(sfc_source)/dT_sfc [W/m2/K]
    grid: SpectralGrid

    @property
    def ncol(self): return self.lay_source.shape[0]
    @property
    def nlay(self): return self.lay_source.shape[1]
    @property
    def ngpt(self): return self.lay_source.shape[2]


def subset_sources(src: SourcesLW, start: int, n: int) -> SourcesLW:
    """Columns [start, start + n)."""
    sl = slice(start, start + n)
    return SourcesLW(lay_source=src.lay_source[sl],
                     lev_source=src.lev_source[sl],
                     sfc_source=src.sfc_source[sl],
                     sfc_source_jac=src.sfc_source_jac[sl], grid=src.grid)
