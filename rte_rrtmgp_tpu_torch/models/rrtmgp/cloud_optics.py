"""RRTMGP cloud optics: particle-size lookup tables.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.cloud_optics`` (reference
``ty_cloud_optics_rrtmgp``, rrtmgp/frontend/mo_cloud_optics_rrtmgp.F90,
and ``compute_cld_from_table``). The per-cell size index, fraction and
masked water path are prepared here in plain PyTorch; the table lerp and
the two-phase sum run in ``ops/kernels/cloud_props`` (CUDA kernel or its
plain twin), differentiable through the twin's gradient. Two outputs:
``cloud_optics`` returns optical properties on the band grid (the public
API), ``cloud_optics_lanes`` the by-band triplet on layer-major cells
(the fused all-sky step).
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ... import trace
from ...config import get_config, resolve_device
from ...ops.kernels.autodiff import with_twin_grad
from ...ops.kernels.cloud_props import cloud_props, cloud_props_plain
from ...optical_props import OpticalProps, OpticalProps1scl, OpticalProps2str
from ...spectral import SpectralGrid

__all__ = ["CloudOpticsRRTMGP"]


def _cloud_props(idx, fint, wp, liq, ice):
    """The LUT kernel with its twin's gradient (the JAX package's
    with_xla_grad, cloud_optics.py:165, :259)."""
    return with_twin_grad(cloud_props, cloud_props_plain, idx, fint, wp, liq,
                          ice)


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
             device=None) -> "CloudOpticsRRTMGP":
        """Build from tables (reference ``load``, :77-214). extice/ssaice/
        asyice arrive (nsize_ice, nbnd, nrghice) in file order and are
        stored roughness-major, on ``device`` (default: the CUDA device)."""
        device = resolve_device(device)
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

    def lane_inputs(self, clwp, ciwp, reliq, dgice, layer_major=True):
        """Per-cell (idx, fint, wp), each (2 phase, nlay, ncol) with
        layer-major cells, or (2 phase, ncol, nlay) without ``layer_major``
        (the index/fraction prep of the JAX package's
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
        lm = lambda x, y: (torch.stack([x.T, y.T]) if layer_major
                           else torch.stack([x, y])).contiguous()
        wp = lm(clwp * (clwp > 0.0).to(clwp.dtype),
                ciwp * (ciwp > 0.0).to(ciwp.dtype))
        return lm(li, ii), lm(lf, if_), wp

    @trace.spanned("cloud.optics")
    def cloud_optics_lanes(self, clwp, ciwp, reliq, dgice):
        """By-band (tau, tau*ssa, tau*ssa*g), each (nbnd, nlay, ncol), from
        (ncol, nlay) water paths [g/m2] and particle sizes [microns]
        (semantics of the JAX ``cloud_optics_lanes``, :229-260)."""
        if get_config().check_values:
            self.validate_inputs(clwp, ciwp, reliq, dgice)
        idx, fint, wp = self.lane_inputs(clwp, ciwp, reliq, dgice)
        out = _cloud_props(idx, fint, wp, *self.tables())
        return out[0], out[1], out[2]

    @trace.spanned("cloud.optics")
    def cloud_optics(self, clwp, ciwp, reliq, dgice, *,
                     scattering: bool = True,
                     top_at_1: bool = True) -> OpticalProps:
        """Cloud optical properties on this object's band grid, each
        (ncol, nlay, nbnd), from (ncol, nlay) water paths [g/m2] and
        particle sizes [microns] (reference ``cloud_optics`` :256-431):
        2-stream (tau, ssa, g), or absorption-only tau (1 - ssa) without
        ``scattering``."""
        if get_config().check_values:
            self.validate_inputs(clwp, ciwp, reliq, dgice)
        idx, fint, wp = self.lane_inputs(clwp, ciwp, reliq, dgice,
                                         layer_major=False)
        tau, taussa, taussag = _cloud_props(idx, fint, wp,
                                            *self.tables()).permute(0, 2, 3, 1)
        if not scattering:
            return OpticalProps1scl(tau=tau - taussa, grid=self.grid,
                                    top_at_1=top_at_1)
        eps = torch.finfo(tau.dtype).eps
        return OpticalProps2str(
            tau=tau.contiguous(), ssa=taussa / torch.clamp(tau, min=eps),
            g=taussag / torch.clamp(taussa, min=eps), grid=self.grid,
            top_at_1=top_at_1)

    @trace.spanned("check.cloud")
    def validate_inputs(self, clwp, ciwp, reliq, dgice) -> None:
        """Range checks (reference :346-353): the liquid and the ice flag
        formed on the device and read back together, one host read.

        A check that passes is remembered for the next call alone: if
        that call is on the same inputs it returns at once (counted in
        ``check.cloud.reused``), and either way the record is spent. So
        the SW call of a step returns on its LW call's check, and the
        next step's LW call reads again. The record is one entry for
        every cloud-optics object in the process (an LW and an SW object
        check the same fields in turn): weak references to the four
        tensors, each tensor's ``_version`` and the four bounds. A call
        returns on it only if each argument is the recorded tensor,
        still alive and at the same version, and its bounds are the
        recorded ones; a check that raises leaves none. Between the two
        calls the record trusts PyTorch's version counter, as autograd's
        check of saved tensors does: every in-place write, through any
        view, bumps it. It cannot see writes that bypass the counter
        (through ``.data``, a DLPack consumer, or a kernel given the
        data pointer). Numpy and inference-mode arguments are checked
        every time."""
        global _checked
        args = (clwp, ciwp, reliq, dgice)
        seen, _checked = _checked, None
        tensors = all(isinstance(a, torch.Tensor) and not a.is_inference()
                      for a in args)
        key = (tuple(a._version for a in args) if tensors else None,
               (self.radliq_lwr, self.radliq_upr,
                self.diamice_lwr, self.diamice_upr))
        if (tensors and seen is not None and seen[1:] == key
                and all(r() is a for r, a in zip(seen[0], args))):
            trace.count("check.cloud.reused")
            return
        liq = (clwp > 0) & ((reliq < self.radliq_lwr)
                            | (reliq > self.radliq_upr))
        ice = (ciwp > 0) & ((dgice < self.diamice_lwr)
                            | (dgice > self.diamice_upr))
        flags = torch.stack([torch.as_tensor(liq.any()),
                             torch.as_tensor(ice.any())])
        with trace.wait("cloud.ranges"):
            bad_liq, bad_ice = flags.cpu().tolist()
        if bad_liq:
            raise ValueError("cloud optics: liquid effective radius is out of bounds")
        if bad_ice:
            raise ValueError("cloud optics: ice effective diameter is out of bounds")
        if tensors:
            _checked = (tuple(map(weakref.ref, args)), *key)


# The last passed cloud range check, until the next call spends it:
# (weak references to its four tensors, their versions, its bounds), or
# None.
_checked = None
