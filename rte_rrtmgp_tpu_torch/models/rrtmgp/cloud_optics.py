"""RRTMGP cloud optics: particle-size lookup tables.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.cloud_optics`` (reference
``ty_cloud_optics_rrtmgp``, rrtmgp/frontend/mo_cloud_optics_rrtmgp.F90,
and ``compute_cld_from_table``). The per-cell size index, fraction and
masked water path are prepared here in plain PyTorch; the table lerp and
the two-phase sum run in ``ops/kernels/cloud_props`` (CUDA kernel or its
plain twin).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import get_config
from ...ops.kernels.cloud_props import cloud_props
from ...spectral import SpectralGrid

__all__ = ["CloudOpticsRRTMGP"]


@dataclasses.dataclass(frozen=True)
class CloudOpticsRRTMGP:
    grid: SpectralGrid
    radliq_lwr: float
    radliq_upr: float
    diamice_lwr: float
    diamice_upr: float
    extliq: torch.Tensor   # (nsize_liq, nbnd)
    ssaliq: torch.Tensor
    asyliq: torch.Tensor
    extice: torch.Tensor   # (nrghice, nsize_ice, nbnd)
    ssaice: torch.Tensor
    asyice: torch.Tensor
    icergh: int = 1        # ice roughness category, 1-based

    @staticmethod
    def load(band_lims_wvn, radliq_lwr, radliq_upr, diamice_lwr, diamice_upr,
             extliq, ssaliq, asyliq, extice, ssaice, asyice,
             band_lims_gpt=None, dtype=torch.float32,
             device="cpu") -> "CloudOpticsRRTMGP":
        """Build from tables (reference ``load``, :77-214). extice/ssaice/
        asyice arrive (nsize_ice, nbnd, nrghice) in file order and are
        stored roughness-major."""
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        ice = lambda a: t(np.moveaxis(np.asarray(a), -1, 0))
        return CloudOpticsRRTMGP(
            grid=SpectralGrid.from_arrays(band_lims_wvn, band_lims_gpt),
            radliq_lwr=float(radliq_lwr), radliq_upr=float(radliq_upr),
            diamice_lwr=float(diamice_lwr), diamice_upr=float(diamice_upr),
            extliq=t(extliq), ssaliq=t(ssaliq), asyliq=t(asyliq),
            extice=ice(extice), ssaice=ice(ssaice), asyice=ice(asyice))

    @property
    def liq_nsteps(self): return self.extliq.shape[0]
    @property
    def ice_nsteps(self): return self.extice.shape[1]
    @property
    def liq_step_size(self):
        return (self.radliq_upr - self.radliq_lwr) / (self.liq_nsteps - 1)
    @property
    def ice_step_size(self):
        return (self.diamice_upr - self.diamice_lwr) / (self.ice_nsteps - 1)

    def tables(self):
        """(liq, ice): each (3, nsize, nbnd) = (ext, ssa, asy), the ice
        one at the selected roughness."""
        r = self.icergh - 1
        return (torch.stack([self.extliq, self.ssaliq, self.asyliq]),
                torch.stack([self.extice[r], self.ssaice[r], self.asyice[r]]))

    def lane_inputs(self, clwp, ciwp, reliq, dgice):
        """Per-cell (idx, fint, wp), each (2 phase, nlay, ncol) with
        layer-major cells (the index/fraction prep of the JAX package's
        ``_lane_triplet_raw``, cloud_optics.py:198-227): idx is the 0-based
        lower size bin, fint the bin fraction (taken from the clipped
        index, so out-of-table sizes extrapolate), wp the water path with
        the phase mask applied. Inputs are (ncol, nlay)."""
        def phase_idx(re, nsteps, step, offset):
            pos = (re - offset) / step
            idx0 = torch.clamp(torch.floor(pos).to(torch.int32), 0, nsteps - 2)
            return idx0, pos - idx0.to(re.dtype)

        li, lf = phase_idx(reliq, self.liq_nsteps, self.liq_step_size,
                           self.radliq_lwr)
        ii, if_ = phase_idx(dgice, self.ice_nsteps, self.ice_step_size,
                            self.diamice_lwr)
        lm = lambda x, y: torch.stack([x.T, y.T]).contiguous()
        wp = lm(clwp * (clwp > 0.0).to(clwp.dtype),
                ciwp * (ciwp > 0.0).to(ciwp.dtype))
        return lm(li, ii), lm(lf, if_), wp

    def cloud_optics_lanes(self, clwp, ciwp, reliq, dgice):
        """By-band (tau, tau*ssa, tau*ssa*g), each (nbnd, nlay, ncol), from
        (ncol, nlay) water paths [g/m2] and particle sizes [microns]
        (semantics of the JAX ``cloud_optics_lanes``, :229-260)."""
        if get_config().check_values:
            self.validate_inputs(clwp, ciwp, reliq, dgice)
        idx, fint, wp = self.lane_inputs(clwp, ciwp, reliq, dgice)
        liq, ice = self.tables()
        out = cloud_props(idx, fint, wp, liq, ice)
        return out[0], out[1], out[2]

    def validate_inputs(self, clwp, ciwp, reliq, dgice) -> None:
        """Range checks (reference :346-353); one host read per check."""
        liq = clwp > 0
        ice = ciwp > 0
        if bool((liq & ((reliq < self.radliq_lwr)
                        | (reliq > self.radliq_upr))).any()):
            raise ValueError("cloud optics: liquid effective radius is out of bounds")
        if bool((ice & ((dgice < self.diamice_lwr)
                        | (dgice > self.diamice_upr))).any()):
            raise ValueError("cloud optics: ice effective diameter is out of bounds")
