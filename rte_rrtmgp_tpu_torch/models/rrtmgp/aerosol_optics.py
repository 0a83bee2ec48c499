"""MERRA2/GOCART aerosol optics.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.aerosol_optics`` (reference
``ty_aerosol_optics_rrtmgp_merra``, rrtmgp/frontend/
mo_aerosol_optics_rrtmgp_merra.F90): per-cell aerosol type dispatch over
seven GOCART species with size-bin selection (dust, sea salt) and
relative-humidity interpolation (the hydrophilic species). The small
lookup tables are concatenated once into one (species, rh, bin) row
table; each cell becomes two row indices (the RH pair), two row gathers
and the RH lerp. Plain PyTorch: the JAX package has no Pallas kernel
here. Tables are stored value-major (ext/ssa/g on axis 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import get_config, resolve_device
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
        the CUDA device)."""
        device = resolve_device(device)

        def vm(a, val_axis):
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

    def validate_inputs(self, aero_type, aero_size, relhum) -> None:
        """Reference bounds checks (:344-347) on cells with a nonzero
        type: size within the bin table, relative humidity in [0, 1].
        One host read per check."""
        active = aero_type > 0
        lims = self.bin_lims
        if bool((active & ((aero_size < float(lims[0, 0]))
                           | (aero_size > float(lims[1, -1])))).any()):
            raise ValueError("aerosol optics: requested aerosol size is out "
                             "of bounds")
        if bool((active & ((relhum < 0.0) | (relhum > 1.0))).any()):
            raise ValueError("aerosol optics: relative humidity fraction is "
                             "out of bounds")

    def aerosol_optics(self, aero_type, aero_size, aero_mass, relhum, *,
                       scattering: bool = True,
                       top_at_1: bool = True) -> OpticalProps:
        """Aerosol optical properties by band (reference aerosol_optics
        :233-430), each (ncol, nlay, nbnd): 2-stream (tau, ssa, g), or the
        absorption tau - tau*ssa without ``scattering``. aero_type
        (ncol, nlay) integer codes; aero_size [microns]; aero_mass
        [kg/m2]; relhum in [0, 1]."""
        tau, taussa, taussag = self._tau_triplet(aero_type, aero_size,
                                                 aero_mass, relhum)
        if not scattering:
            return OpticalProps1scl(tau=tau - taussa, grid=self.grid,
                                    top_at_1=top_at_1)
        eps = torch.finfo(tau.dtype).eps
        return OpticalProps2str(
            tau=tau, ssa=taussa / torch.clamp(tau, min=eps),
            g=taussag / torch.clamp(taussa, min=eps), grid=self.grid,
            top_at_1=top_at_1)

    def aerosol_optics_lanes(self, aero_type, aero_size, aero_mass, relhum):
        """(tau, tau*ssa, tau*ssa*g) by band, each (nbnd, nlay, ncol) (a
        permuted view; the contract of ``cloud_optics_lanes``)."""
        lane = lambda x: x.permute(2, 1, 0)
        return tuple(lane(x) for x in self._tau_triplet(
            aero_type, aero_size, aero_mass, relhum))

    def _row_table(self):
        """The (species, rh, bin) rows, (nrows, 3 * nbnd), and each
        species' first row; row 0 is zero (no or unknown type). Built once
        per instance (JAX aerosol_optics.py:146-178)."""
        cached = self.__dict__.get("_rows")
        if cached is not None:
            return cached
        nbnd, nbin, nrh = self.nbnd, self.nbin, self.nrh
        blocks = [("none", self.dust_tbl.new_zeros((1, 3, nbnd))),
                  ("dust", self.dust_tbl.movedim(0, 1)),
                  ("salt", self.salt_tbl.movedim(0, 2).reshape(
                      nrh * nbin, 3, nbnd)),
                  ("sulf", self.sulf_tbl.movedim(0, 1)),
                  ("bcar_rh", self.bcar_rh_tbl.movedim(0, 1)),
                  ("bcar", self.bcar_tbl[None]),
                  ("ocar_rh", self.ocar_rh_tbl.movedim(0, 1)),
                  ("ocar", self.ocar_tbl[None])]
        off, n = {}, 0
        for name, b in blocks:
            off[name] = n
            n += b.shape[0]
        table = torch.cat([b for _, b in blocks]).reshape(-1, 3 * nbnd)
        object.__setattr__(self, "_rows", (table, off))
        return table, off

    def _tau_triplet(self, aero_type, aero_size, aero_mass, relhum):
        """(tau, tau*ssa, tau*ssa*g), each (ncol, nlay, nbnd) (JAX
        aerosol_optics.py:180-243)."""
        if get_config().check_values:
            self.validate_inputs(aero_type, aero_size, relhum)
        atype = aero_type.to(torch.int32)
        size = aero_size
        dtype = size.dtype
        mass = aero_mass.to(dtype)
        rh = relhum.to(dtype)

        # size bin: the last bin whose [lo, hi] holds the size (ref :472-477)
        lims = self.bin_lims
        ibin = torch.zeros_like(atype)
        for i in range(self.nbin):
            inbin = (size >= float(lims[0, i])) & (size <= float(lims[1, i]))
            ibin = torch.where(inbin, i, ibin)

        # RH pair (ref :481-494): irh2 is the first grid point >= rh
        rh_grid = torch.as_tensor(self.aero_rh, dtype=dtype,
                                  device=size.device)
        nbelow = (rh[..., None] > rh_grid).sum(-1)
        irh1 = torch.where(nbelow == 0, 0,
                           torch.clamp(nbelow, 1, self.nrh) - 1)
        irh2 = torch.clamp(nbelow, 0, self.nrh - 1)
        same = irh1 == irh2
        drh0 = rh_grid[irh2] - rh_grid[irh1]
        drh1 = rh - rh_grid[irh1]
        rdrh = torch.where(same, 0.0, drh1 / torch.where(same, 1.0, drh0))

        table, off = self._row_table()
        nbin = self.nbin

        def rows_of(irh):
            r = torch.zeros_like(atype)
            for code, base, idx in (
                    (MERRA_AERO_DUST, off["dust"], ibin),
                    (MERRA_AERO_SALT, off["salt"], irh * nbin + ibin),
                    (MERRA_AERO_SULF, off["sulf"], irh),
                    (MERRA_AERO_BCAR_RH, off["bcar_rh"], irh),
                    (MERRA_AERO_BCAR, off["bcar"], 0),
                    (MERRA_AERO_OCAR_RH, off["ocar_rh"], irh),
                    (MERRA_AERO_OCAR, off["ocar"], 0)):
                r = torch.where(atype == code, base + idx, r)
            return r.long()

        lo = table[rows_of(irh1)]                   # (ncol, nlay, 3 * nbnd)
        hi = table[rows_of(irh2)]
        v = (lo + rdrh[..., None] * (hi - lo)).reshape(
            tuple(atype.shape) + (3, self.nbnd))
        tau = mass[..., None] * v[..., 0, :]
        taussa = tau * v[..., 1, :]
        return tau, taussa, taussa * v[..., 2, :]
