"""The k-distribution container and its load-time transforms.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.kdist`` (reference
``ty_gas_optics_rrtmgp`` state and ``load_int/load_ext ->
init_abs_coeffs``, rrtmgp/frontend/mo_gas_optics_rrtmgp.F90:938-1381):
gas filtering, minor-array reduction, flavor and g-point-flavor maps,
derived interpolation constants and the default solar source. Metadata
stays host numpy; the lookup tables are tensors in their plain layouts:
kmajor/planck_frac (ntemp, neta, npres+1, ngpt), kminor (ntemp, neta,
ncontrib), krayl (ntemp, neta, ngpt, 2), totplnk (nPlanckTemp, nbnd).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...spectral import SpectralGrid

__all__ = ["KDist", "MinorSet"]

# NRLSSI2 offsets (reference mo_gas_optics_rrtmgp.F90:776-777)
_A_OFFSET = 0.1495954
_B_OFFSET = 0.00066696


@dataclasses.dataclass(frozen=True)
class MinorSet:
    """Per-atmosphere minor-gas metadata (post-reduction). All indices
    0-based; ``idx_minor``/``idx_minor_scaling`` index col_gas (0 = dry
    air), -1 = no scaling gas."""
    gas_names: tuple
    limits_gpt: tuple                # ((g0, g1), ...) 0-based inclusive
    scales_with_density: tuple
    scale_by_complement: tuple
    idx_minor: tuple
    idx_minor_scaling: tuple
    kminor_start: tuple              # 0-based into kminor
    flavor: tuple = ()               # 0-based flavor of each window

    def __len__(self):
        return len(self.gas_names)


def _lower(s):
    return str(s).strip().lower()


@dataclasses.dataclass(frozen=True)
class KDist:
    grid: SpectralGrid
    gas_names: tuple                 # reduced, lower-case
    flavor: np.ndarray               # (2, nflav) int, indexes col_gas
    gpoint_flavor: np.ndarray        # (2, ngpt) int 0-based flavor
    press_ref_log: np.ndarray        # (npres,) float64
    temp_ref: np.ndarray             # (ntemp,) float64
    press_ref_trop_log: float
    press_ref_log_delta: float
    temp_ref_min: float
    temp_ref_delta: float
    temp_ref_max: float
    vmr_ref: np.ndarray              # (2, ngas+1, ntemp), 0 = dry air
    minor_lower: MinorSet
    minor_upper: MinorSet
    neta: int
    kmajor: torch.Tensor             # (ntemp, neta, npres+1, ngpt)
    kminor_lower: torch.Tensor       # (ntemp, neta, ncont_lower)
    kminor_upper: torch.Tensor
    krayl: Optional[torch.Tensor]    # (ntemp, neta, ngpt, 2), SW
    planck_frac: Optional[torch.Tensor]   # (ntemp, neta, npres+1, ngpt), LW
    totplnk: Optional[torch.Tensor]       # (nPlanckTemp, nbnd), LW
    totplnk_delta: float
    solar_source: Optional[torch.Tensor]  # (ngpt,), SW

    @property
    def ngpt(self) -> int:
        return self.grid.ngpt

    def source_is_internal(self) -> bool:
        return self.totplnk is not None

    def source_is_external(self) -> bool:
        return self.solar_source is not None

    def idx_gas(self, name: str) -> int:
        """1-based index into col_gas (0 = dry air); -1 if absent."""
        key = _lower(name)
        return self.gas_names.index(key) + 1 if key in self.gas_names else -1

    @staticmethod
    def from_raw(available_gases,
                 gas_names, key_species, band_lims_gpt, band_lims_wvn,
                 press_ref, press_ref_trop, temp_ref,
                 vmr_ref,
                 kmajor, kminor_lower, kminor_upper,
                 gas_minor, identifier_minor,
                 minor_gases_lower, minor_gases_upper,
                 minor_limits_gpt_lower, minor_limits_gpt_upper,
                 minor_scales_with_density_lower, minor_scales_with_density_upper,
                 scaling_gas_lower, scaling_gas_upper,
                 scale_by_complement_lower, scale_by_complement_upper,
                 kminor_start_lower, kminor_start_upper,
                 rayl_lower=None, rayl_upper=None,
                 totplnk=None, planck_frac=None, optimal_angle_fit=None,
                 solar_quiet=None, solar_facular=None, solar_sunspot=None,
                 tsi_default=None, mg_default=None, sb_default=None,
                 dtype=torch.float32, device="cpu") -> "KDist":
        """Build a KDist from raw arrays in the conventions of the JAX
        package's ``KDist.from_raw`` (1-based gas, g-point and kminor
        indices; tables temperature-major). ``optimal_angle_fit`` is
        accepted and unused: this slice has no optimal-angle API."""
        avail = {_lower(g) for g in available_gases}
        gas_names = [_lower(g) for g in gas_names]
        gas_minor = [_lower(g) for g in gas_minor]
        identifier_minor = [_lower(g) for g in identifier_minor]

        # ---- gas filtering (reference :1222-1249) ----
        red = [g for g in gas_names if g in avail]
        vmr_ref = np.asarray(vmr_ref, np.float64)
        vmr_red = np.empty((2, len(red) + 1, vmr_ref.shape[2]))
        vmr_red[:, 0, :] = vmr_ref[:, 0, :]     # dry air
        for i, g in enumerate(red):
            vmr_red[:, i + 1, :] = vmr_ref[:, gas_names.index(g) + 1, :]

        # ---- key species remap + flavors (reference :1346-1353) ----
        key_species = np.asarray(key_species, np.int64)  # (2, 2, nbnd)
        ks_red = np.zeros_like(key_species)
        missing = []
        for ip, ia, ib in np.ndindex(*key_species.shape):
            k = key_species[ip, ia, ib]
            if k != 0:
                name = gas_names[k - 1]
                if name in red:
                    ks_red[ip, ia, ib] = red.index(name) + 1
                else:
                    missing.append(name)
        if missing:
            raise ValueError(f"gas_optics: required gases "
                             f"{sorted(set(missing))} are not provided")

        def rewrite(pair):
            return (2, 2) if tuple(pair) == (0, 0) else tuple(pair)

        nbnd = key_species.shape[2]
        flavor_list = []
        for ib in range(nbnd):
            for ia in range(2):
                pair = rewrite(ks_red[:, ia, ib])
                if pair not in flavor_list:
                    flavor_list.append(pair)
        flavor = np.asarray(flavor_list, np.int64).T         # (2, nflav)

        grid = SpectralGrid.from_arrays(band_lims_wvn, band_lims_gpt)
        ngpt = grid.ngpt
        blg = np.asarray(band_lims_gpt, np.int64)
        expect_start = 1
        for b in range(blg.shape[0]):
            if blg[b, 0] != expect_start or blg[b, 1] < blg[b, 0]:
                raise ValueError(
                    "from_raw: band_lims_gpt must be contiguous ascending "
                    f"from g-point 1; band {b} spans {blg[b].tolist()}")
            expect_start = int(blg[b, 1]) + 1
        if expect_start != ngpt + 1:
            raise ValueError(f"from_raw: band_lims_gpt does not cover [1, {ngpt}]")
        gpoint_flavor = np.zeros((2, ngpt), np.int64)
        for igpt in range(ngpt):
            for ia in range(2):
                pair = rewrite(ks_red[:, ia, grid.gpt2band[igpt]])
                gpoint_flavor[ia, igpt] = flavor_list.index(pair)

        # ---- minor reduction (reference reduce_minor_arrays :1790-1907) ----
        def reduce_minor(kminor, names, limits, swd, sgas, sbc, kstart, atm):
            names = [_lower(n) for n in names]
            limits = np.asarray(limits, np.int64).reshape(-1, 2)
            kstart = np.asarray(kstart, np.int64)
            kminor = np.asarray(kminor)
            keep, k_slices, new_start, tot = [], [], [], 0
            for i, ident in enumerate(names):
                if gas_minor[identifier_minor.index(ident)] not in avail:
                    continue
                w = int(limits[i, 1] - limits[i, 0] + 1)
                keep.append(i)
                s0 = int(kstart[i] - 1)
                k_slices.append(kminor[:, :, s0:s0 + w])
                new_start.append(tot)
                tot += w
            k_red = (np.concatenate(k_slices, axis=-1) if keep
                     else np.zeros(kminor.shape[:2] + (0,)))
            idx_minor, idx_scaling = [], []
            for i in keep:
                idx_minor.append(
                    red.index(gas_minor[identifier_minor.index(names[i])]) + 1)
                sg = _lower(sgas[i])
                idx_scaling.append(red.index(sg) + 1 if sg in red else -1)
            limits_gpt = tuple((int(limits[i, 0] - 1), int(limits[i, 1] - 1))
                               for i in keep)
            mset = MinorSet(
                gas_names=tuple(names[i] for i in keep),
                limits_gpt=limits_gpt,
                scales_with_density=tuple(bool(swd[i]) for i in keep),
                scale_by_complement=tuple(bool(sbc[i]) for i in keep),
                idx_minor=tuple(idx_minor),
                idx_minor_scaling=tuple(idx_scaling),
                kminor_start=tuple(new_start),
                flavor=tuple(int(gpoint_flavor[atm, g0])
                             for (g0, _) in limits_gpt))
            return mset, k_red

        mlow, klow = reduce_minor(
            kminor_lower, minor_gases_lower, minor_limits_gpt_lower,
            minor_scales_with_density_lower, scaling_gas_lower,
            scale_by_complement_lower, kminor_start_lower, 0)
        mupp, kupp = reduce_minor(
            kminor_upper, minor_gases_upper, minor_limits_gpt_upper,
            minor_scales_with_density_upper, scaling_gas_upper,
            scale_by_complement_upper, kminor_start_upper, 1)

        # ---- derived interpolation constants (reference :1356-1365) ----
        press_ref = np.asarray(press_ref, np.float64)
        temp_ref = np.asarray(temp_ref, np.float64)
        npres = press_ref.shape[0]
        ntemp = temp_ref.shape[0]
        press_ref_log_delta = ((np.log(press_ref[-1]) - np.log(press_ref[0]))
                               / (npres - 1))
        temp_ref_min = float(temp_ref[0])
        temp_ref_max = float(temp_ref[-1])
        temp_ref_delta = (temp_ref_max - temp_ref_min) / (ntemp - 1)

        tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device)
        if (rayl_lower is None) != (rayl_upper is None):
            raise ValueError("rayl_lower and rayl_upper must both be provided")
        krayl = (tensor(np.stack([rayl_lower, rayl_upper], axis=-1))
                 if rayl_lower is not None else None)

        totplnk_delta = 0.0
        totplnk_t = planck_t = None
        if totplnk is not None:
            if planck_frac is None:
                raise ValueError("from_raw: totplnk requires planck_frac")
            totplnk_delta = ((temp_ref_max - temp_ref_min)
                             / (np.asarray(totplnk).shape[0] - 1))
            totplnk_t = tensor(totplnk)
            planck_t = tensor(planck_frac)

        src = None
        if solar_quiet is not None:
            # reference set_solar_variability (:760-798) then set_tsi,
            # in the working dtype as the JAX package computes it
            mg = mg_default if mg_default is not None else _A_OFFSET
            sb = sb_default if sb_default is not None else _B_OFFSET
            src = (tensor(solar_quiet) + (mg - _A_OFFSET) * tensor(solar_facular)
                   + (sb - _B_OFFSET) * tensor(solar_sunspot))
            if tsi_default is not None:
                src = src * (tsi_default * (1.0 / torch.sum(src)))

        return KDist(
            grid=grid, gas_names=tuple(red), flavor=flavor,
            gpoint_flavor=gpoint_flavor,
            press_ref_log=np.log(press_ref), temp_ref=temp_ref,
            press_ref_trop_log=float(np.log(press_ref_trop)),
            press_ref_log_delta=float(press_ref_log_delta),
            temp_ref_min=temp_ref_min, temp_ref_delta=float(temp_ref_delta),
            temp_ref_max=temp_ref_max,
            vmr_ref=vmr_red, minor_lower=mlow, minor_upper=mupp,
            neta=int(np.asarray(kmajor).shape[1]),
            kmajor=tensor(kmajor), kminor_lower=tensor(klow),
            kminor_upper=tensor(kupp), krayl=krayl,
            planck_frac=planck_t, totplnk=totplnk_t,
            totplnk_delta=float(totplnk_delta), solar_source=src)
