"""MERRA2/GOCART aerosol optics.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.aerosol_optics`` (reference
``ty_aerosol_optics_rrtmgp_merra``, rrtmgp/frontend/
mo_aerosol_optics_rrtmgp_merra.F90): per-cell aerosol type dispatch over
seven GOCART species with size-bin selection (dust, sea salt) and
relative-humidity interpolation (the hydrophilic species). The small
lookup tables are concatenated once, at load, into one (species, rh,
bin) row table on the tables' device, beside the RH grid and the bin
limits (``lut``); the lookup runs in ``ops/kernels/aerosol_props`` (one
CUDA launch per call, or its plain twin), differentiable through the
twin's gradient. The all-sky step asks it for its increments by band
with the clouds' folded in (:meth:`AerosolOpticsMERRA.absorption_lanes`,
:meth:`AerosolOpticsMERRA.scattering_lanes`). Tables are stored
value-major (ext/ssa/g on axis 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import trace
from ...config import get_config, resolve_device
from ...ops.kernels.aerosol_props import (LANES, LW, SW, aerosol_props,
                                          aerosol_props_plain)
from ...ops.kernels.autodiff import with_twin_grad
from ...optical_props import OpticalProps, OpticalProps1scl, OpticalProps2str
from ...spectral import SpectralGrid

__all__ = ["AerosolOpticsMERRA", "MERRA_AERO_NONE", "MERRA_AERO_DUST",
           "MERRA_AERO_SALT", "MERRA_AERO_SULF", "MERRA_AERO_BCAR_RH",
           "MERRA_AERO_BCAR", "MERRA_AERO_OCAR_RH", "MERRA_AERO_OCAR",
           "MERRA_NTYPE"]

# aerosol type codes (reference :43-52)
MERRA_NTYPE = 7
MERRA_AERO_NONE = 0
MERRA_AERO_DUST = 1
MERRA_AERO_SALT = 2
MERRA_AERO_SULF = 3
MERRA_AERO_BCAR_RH = 4
MERRA_AERO_BCAR = 5
MERRA_AERO_OCAR_RH = 6
MERRA_AERO_OCAR = 7


@dataclasses.dataclass(frozen=True)
class AerosolOpticsMERRA:
    grid: SpectralGrid
    bin_lims: np.ndarray          # (2, nbin) size-bin limits [microns]
    aero_rh: np.ndarray           # (nrh,) RH grid
    dust_tbl: torch.Tensor        # (3, nbin, nbnd)    [ext/ssa/g, ...]
    salt_tbl: torch.Tensor        # (3, nrh, nbin, nbnd)
    sulf_tbl: torch.Tensor        # (3, nrh, nbnd)
    bcar_tbl: torch.Tensor        # (3, nbnd)
    bcar_rh_tbl: torch.Tensor     # (3, nrh, nbnd)
    ocar_tbl: torch.Tensor        # (3, nbnd)
    ocar_rh_tbl: torch.Tensor     # (3, nrh, nbnd)

    @staticmethod
    def load(band_lims_wvn, merra_aero_bin_lims, aero_rh,
             aero_dust_tbl, aero_salt_tbl, aero_sulf_tbl,
             aero_bcar_tbl, aero_bcar_rh_tbl,
             aero_ocar_tbl, aero_ocar_rh_tbl,
             dtype=torch.float32, device=None) -> "AerosolOpticsMERRA":
        """Build from tables in the reference's in-memory order (load_lut
        :96-165): dust (nval, nbin, nbnd), salt (nrh, nval, nbin, nbnd),
        sulfate/bcar_rh/ocar_rh (nrh, nval, nbnd), bcar/ocar (nval, nbnd),
        nval = 3 = ext/ssa/g. Stored value-major on ``device`` (default:
        the CUDA device). A table may be a tensor already on ``device``:
        it is rearranged there, with no trip through the host."""
        device = resolve_device(device)

        def vm(a, val_axis):
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=dtype).movedim(
                    val_axis, 0).contiguous()
            return torch.as_tensor(np.moveaxis(np.asarray(a), val_axis, 0),
                                   dtype=dtype, device=device).contiguous()

        return AerosolOpticsMERRA(
            grid=SpectralGrid.from_arrays(band_lims_wvn),
            bin_lims=np.asarray(merra_aero_bin_lims,
                                np.float64).reshape(2, -1),
            aero_rh=np.asarray(aero_rh, np.float64),
            dust_tbl=vm(aero_dust_tbl, 0), salt_tbl=vm(aero_salt_tbl, 1),
            sulf_tbl=vm(aero_sulf_tbl, 1), bcar_tbl=vm(aero_bcar_tbl, 0),
            bcar_rh_tbl=vm(aero_bcar_rh_tbl, 1),
            ocar_tbl=vm(aero_ocar_tbl, 0),
            ocar_rh_tbl=vm(aero_ocar_rh_tbl, 1))

    @property
    def nbin(self): return self.bin_lims.shape[1]
    @property
    def nrh(self): return self.aero_rh.shape[0]
    @property
    def nbnd(self): return self.grid.nband

    def __post_init__(self):
        """The lookup's tables on the tables' device, made once (JAX
        aerosol_optics.py:146-178): the bin limits (2, nbin), the RH grid
        (nrh,) and the (species, rh, bin) rows (nrows, 3, nbnd), row 0
        zero (no or unknown type); and each species' first row."""
        nbnd, nbin, nrh = self.nbnd, self.nbin, self.nrh
        tab = self.dust_tbl
        blocks = [("none", tab.new_zeros((1, 3, nbnd))),
                  ("dust", self.dust_tbl.movedim(0, 1)),
                  ("salt", self.salt_tbl.movedim(0, 2).reshape(
                      nrh * nbin, 3, nbnd)),
                  ("sulf", self.sulf_tbl.movedim(0, 1)),
                  ("bcar_rh", self.bcar_rh_tbl.movedim(0, 1)),
                  ("bcar", self.bcar_tbl[None]),
                  ("ocar_rh", self.ocar_rh_tbl.movedim(0, 1)),
                  ("ocar", self.ocar_tbl[None])]
        first, n = {}, 0
        for name, b in blocks:
            first[name] = n
            n += b.shape[0]
        on = lambda a: torch.as_tensor(a, dtype=tab.dtype, device=tab.device)
        lut = (on(self.bin_lims), on(self.aero_rh),
               torch.cat([b for _, b in blocks]).contiguous())
        object.__setattr__(self, "lut", lut)
        object.__setattr__(self, "offsets", tuple(first[k] for k in (
            "dust", "salt", "sulf", "bcar_rh", "bcar", "ocar_rh", "ocar")))

    @trace.spanned("check.aerosol")
    def validate_inputs(self, aero_type, aero_size, relhum) -> None:
        """Reference bounds checks (:344-347) on cells with a nonzero
        type: size within the bin table, relative humidity in [0, 1]. Both
        flags formed on the device and read back together, one host
        read."""
        active = aero_type > 0
        lims = self.bin_lims
        size = active & ((aero_size < float(lims[0, 0]))
                         | (aero_size > float(lims[1, -1])))
        rh = active & ((relhum < 0.0) | (relhum > 1.0))
        flags = torch.stack([size.any(), rh.any()])
        with trace.wait("aerosol.ranges"):
            bad_size, bad_rh = flags.cpu().tolist()
        if bad_size:
            raise ValueError("aerosol optics: requested aerosol size is out "
                             "of bounds")
        if bad_rh:
            raise ValueError("aerosol optics: relative humidity fraction is "
                             "out of bounds")

    def _props(self, mode, cloud, aero_type, aero_size, aero_mass, relhum):
        """One call of the lookup kernel (or its twin) in ``mode``, with
        the twin's gradient (``ops/kernels/aerosol_props``)."""
        if get_config().check_values:
            self.validate_inputs(aero_type, aero_size, relhum)
        size = aero_size.contiguous()
        cast = lambda x: x.to(size.dtype).contiguous()
        return with_twin_grad(
            aerosol_props, aerosol_props_plain,
            aero_type.to(torch.int32).contiguous(), size, cast(aero_mass),
            cast(relhum), self.lut, self.offsets, cloud, mode,
            name="aerosol_props")

    @trace.spanned("aerosol.optics")
    def aerosol_optics(self, aero_type, aero_size, aero_mass, relhum, *,
                       scattering: bool = True,
                       top_at_1: bool = True) -> OpticalProps:
        """Aerosol optical properties by band (reference aerosol_optics
        :233-430), each (ncol, nlay, nbnd): 2-stream (tau, ssa, g), or the
        absorption tau - tau*ssa without ``scattering``. aero_type
        (ncol, nlay) integer codes; aero_size [microns]; aero_mass
        [kg/m2]; relhum in [0, 1]."""
        x = (aero_type, aero_size, aero_mass, relhum)
        if not scattering:
            return OpticalProps1scl(
                tau=self._props(LW, None, *x).permute(2, 1, 0),
                grid=self.grid, top_at_1=top_at_1)
        tau, taussa, taussag = self._props(LANES, None, *x).permute(
            0, 3, 2, 1)
        eps = torch.finfo(tau.dtype).eps
        return OpticalProps2str(
            tau=tau, ssa=taussa / torch.clamp(tau, min=eps),
            g=taussag / torch.clamp(taussa, min=eps), grid=self.grid,
            top_at_1=top_at_1)

    @trace.spanned("aerosol.optics")
    def aerosol_optics_lanes(self, aero_type, aero_size, aero_mass, relhum):
        """(tau, tau*ssa, tau*ssa*g) by band, each (nbnd, nlay, ncol) (the
        contract of ``cloud_optics_lanes``)."""
        out = self._props(LANES, None, aero_type, aero_size, aero_mass,
                          relhum)
        return out[0], out[1], out[2]

    @trace.spanned("aerosol.optics")
    def absorption_lanes(self, aero_type, aero_size, aero_mass, relhum, *,
                         cloud=None):
        """The all-sky step's LW increment by band, (nbnd, nlay, ncol):
        the aerosols' absorption tau - tau*ssa plus the clouds', where
        ``cloud`` (their (tau, tau*ssa, tau*ssa*g) lanes) is given
        (reference increment_1scalar_by_2stream; JAX drivers/allsky.py:
        122-128). One launch."""
        return self._props(LW, cloud, aero_type, aero_size, aero_mass,
                           relhum)

    @trace.spanned("aerosol.optics")
    def scattering_lanes(self, aero_type, aero_size, aero_mass, relhum, *,
                         cloud=None):
        """The all-sky step's SW increment by band, delta-scaled
        (tau, ssa, g), each (nbnd, nlay, ncol): the aerosols' combined
        with the clouds', where ``cloud`` (their (tau, tau*ssa,
        tau*ssa*g) lanes) is given (JAX drivers/allsky.py:288-301). One
        launch."""
        out = self._props(SW, cloud, aero_type, aero_size, aero_mass, relhum)
        return out[0], out[1], out[2]
