"""RRTMGP gas-optics front end.

Counterpart of ``rte_rrtmgp_tpu.models.rrtmgp.gas_optics`` (reference
``ty_gas_optics_rrtmgp`` run-time methods, rrtmgp/frontend/
mo_gas_optics_rrtmgp.F90): column amounts, the interpolation descriptors,
the minor-gas scaling rows and Rayleigh scaling (the descriptor prep:
the column amounts and interpolation descriptors one launch of
``ops/kernels/gas_descriptors`` and the minor-gas scaling rows one launch of
``ops/kernels/minor_scale`` per call on the card, where the JAX package
forms them in plain JAX), then three routes:

  * the public API, ``gas_optics_lw`` / ``gas_optics_sw`` (reference
    gas_optics_int :220-331 / gas_optics_ext :337-414), returning optical
    properties (ncol, nlay, ngpt) and sources: the staged gathers
    ``ops/kernels/gas_major`` and ``ops/kernels/gas_minor`` (major, minor
    and Rayleigh) on (ncol, nlay) cells, then the Planck sources in plain
    PyTorch;
  * the staged lane-layout branch, ``gas_optics_lw_lanes`` /
    ``gas_optics_sw_lanes``: the same gathers, returned as (ngpt, nlay,
    ncol) views for the lane solvers (``ops/kernels/solver_lanes``), with
    band Planck values or a split Rayleigh depth for the solvers that
    form the sources or the combine themselves;
  * one call of the fused LW or SW kernel (``ops/kernels/fused_*``) on
    layer-major (nlay, ncol) cells, for the all-sky step.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import trace
from ...gas_concs import GasConcs
from ...optical_props import (OpticalProps, OpticalProps1scl,
                              OpticalProps2str)
from ...ops.gas_optics import (InterpCoeffs, column_amounts, get_col_dry,
                               interp_tables, interpolation,
                               planck_bands_lanes, planck_sources, tau_minor,
                               window_rows)
from ...ops.kernels.autodiff import with_twin_grad
from ...ops.kernels.fused_lw import (LWFusedInputs, _split_minors,
                                     interleave_kmajor_pfrac, lw_fused)
from ...ops.kernels.fused_sw import SWFusedInputs, sw_fused
from ...ops.kernels.gas_descriptors import gas_descriptors
from ...ops.kernels.gas_major import gas_major, gas_major_plain
from ...ops.kernels.gas_minor import gas_minor, gas_rayleigh, rayleigh_combine
from ...ops.kernels.minor_scale import minor_scale
from ...sources import SourcesLW
from ..base import infer_top_at_1
from .kdist import KDist

__all__ = ["GasOpticsRRTMGP", "get_col_dry", "interp_tlev", "vmr_rows"]


@trace.spanned("optics.major")
def _major(co, kmajor, planck_frac, gpoint_flavor, kmajor_pfrac=None):
    """gas_major with its twin's gradient; the kernel reads the LW table of
    (kmajor, planck_frac) pairs, which an LW call on CUDA must pass."""
    return with_twin_grad(gas_major, gas_major_plain, co, kmajor,
                          planck_frac, gpoint_flavor, kmajor_pfrac)


@trace.spanned("optics.minor")
def _minor(tau, co, kminor, minors, meta, scaling):
    """gas_minor out of place: the kernel reads ``tau`` and writes a new
    tensor, ``tau`` untouched."""
    def kernel(t, *a):
        return gas_minor(t, *a, out=torch.empty_like(
            t, memory_format=torch.contiguous_format))
    return with_twin_grad(
        kernel,
        lambda t, c, k, m, _, s: tau_minor(t.movedim(-1, 0), c, k, m,
                                           s).movedim(0, -1),
        tau, co, kminor, minors, meta, scaling, name="gas_minor")


@trace.spanned("optics.rayleigh")
def _rayleigh(tau, co, krayl, gpoint_flavor, rayscale, scattering):
    """gas_rayleigh out of place: (tau + tau_rayleigh, ssa or None); the
    kernel reads ``tau`` and writes a new tensor, ``tau`` untouched. A None
    ``tau`` gives the Rayleigh optical depth alone (0 + Rayleigh)."""
    def kernel(t, c, k, f, r):
        out = torch.empty(tuple(c.jtemp.shape) + (k.shape[2],),
                          dtype=r.dtype, device=r.device)
        return gas_rayleigh(t, c, k, f, r, scattering=scattering, out=out)
    return with_twin_grad(
        kernel, lambda *a: rayleigh_combine(*a, scattering=scattering),
        tau, co, krayl, gpoint_flavor, rayscale, name="gas_rayleigh")


def vmr_rows(kdist: KDist, gas_concs: GasConcs, ncol: int, nlay: int):
    """One stored vmr (scalar, profile or field) or None (absent) per
    col_gas row past dry air, and the 1-based h2o row (a None row is
    appended when the k-distribution has no h2o)."""
    vmrs = tuple(gas_concs.stored_vmr(g, ncol, nlay)
                 if g in gas_concs else None for g in kdist.gas_names)
    idx_h2o = kdist.idx_gas("h2o")
    if idx_h2o < 0:
        vmrs += (None,)
        idx_h2o = len(vmrs)
    return vmrs, idx_h2o


def interp_tlev(tlay, play, plev):
    """Pressure-weighted interpolation/extrapolation of layer temperatures
    to levels (reference source() :893-911)."""
    t0 = tlay[:, :1] + (plev[:, :1] - play[:, :1]) * (
        tlay[:, 1:2] - tlay[:, :1]) / (play[:, 1:2] - play[:, :1])
    tn = tlay[:, -1:] + (plev[:, -1:] - play[:, -1:]) * (
        tlay[:, -1:] - tlay[:, -2:-1]) / (play[:, -1:] - play[:, -2:-1])
    interior = (play[:, :-1] * tlay[:, :-1] * (plev[:, 1:-1] - play[:, 1:])
                + play[:, 1:] * tlay[:, 1:] * (play[:, :-1] - plev[:, 1:-1])
                ) / (plev[:, 1:-1] * (play[:, :-1] - play[:, 1:]))
    return torch.cat([t0, interior, tn], dim=1)


class GasOpticsRRTMGP:
    """Gas-optics provider over a :class:`KDist` whose tables live on one
    device; the static per-g-point and per-minor metadata is moved there
    once, here."""

    def __init__(self, kdist: KDist):
        self.kdist = kdist
        self.grid = kdist.grid
        dev = kdist.kmajor.device
        i32 = torch.int32
        self.gpoint_flavor = torch.as_tensor(kdist.gpoint_flavor, dtype=i32,
                                             device=dev)
        self.gpt2band = torch.as_tensor(kdist.grid.gpt2band, dtype=i32,
                                        device=dev)
        minors = []
        for lower, mset in ((1, kdist.minor_lower), (0, kdist.minor_upper)):
            for m in range(len(mset)):
                g0, g1 = mset.limits_gpt[m]
                minors.append((lower, int(mset.flavor[m]), int(g0),
                               int(g1 - g0 + 1), int(mset.kminor_start[m])))
        self.minors = tuple(minors)
        self.minor_meta = torch.as_tensor(self.minors, dtype=i32,
                                          device=dev).reshape(-1, 5)
        # the minor windows' scaling rows, lower first (ops/kernels/
        # minor_scale: the host rows for the twin, their device table for
        # the kernel)
        self.minor_windows = (window_rows(kdist.minor_lower, True)
                              + window_rows(kdist.minor_upper, False))
        self.minor_scale_table = torch.as_tensor(
            self.minor_windows, dtype=i32, device=dev).reshape(-1, 5)
        # the LW gather table of the fused LW kernel (LWFusedInputs.
        # kmajor_pfrac) and of the major-gas gather
        self.kmajor_pfrac = (
            None if kdist.planck_frac is None
            else interleave_kmajor_pfrac(kdist.kmajor, kdist.planck_frac))
        # the interpolation's tables on the device, per dtype (ops/
        # gas_optics.interp_tables): the kernel and its twin read these,
        # so no call copies from the host
        self.interp_tables = {dt: interp_tables(kdist, dt, dev)
                              for dt in (torch.float32, torch.float64)}

    @property
    def ngpt(self) -> int:
        return self.kdist.ngpt

    @property
    def device(self) -> torch.device:
        return self.kdist.kmajor.device

    def source_is_internal(self) -> bool:
        return self.kdist.source_is_internal()

    def source_is_external(self) -> bool:
        return self.kdist.source_is_external()

    @trace.spanned("check.key_species")
    def _check_key_species_present(self, gas_concs: GasConcs):
        """Reference check_key_species_present (:1403-1422)."""
        kd = self.kdist
        key = {kd.gas_names[g - 1] for pair in kd.flavor.T for g in pair
               if g > 0}
        missing = sorted(g for g in key if g not in gas_concs)
        if missing:
            raise ValueError(f"gas_optics: required gases {missing} are not provided")

    def col_gas(self, play, plev, gas_concs: GasConcs, col_dry=None):
        """VMR gather + column amounts (reference compute_gas_taus
        :538-609): (ngas+1, ncol, nlay) with col_gas[0] = col_dry and
        col_gas[i] = vmr_i * col_dry; plus col_dry (computed from the
        pressures unless given) and the 1-based h2o row (a zeros row is
        appended when the k-distribution has no h2o). The plain twin of
        the kernel's col_gas (:meth:`_gas_descriptors`)."""
        vmrs, idx_h2o = vmr_rows(self.kdist, gas_concs, *play.shape)
        col_gas = column_amounts(play, plev, vmrs, col_dry, idx_h2o)
        return col_gas, col_gas[0], idx_h2o

    def _gas_descriptors(self, play, plev, tlay, gas_concs: GasConcs,
                         col_dry, layer_major: bool):
        """The key species' check, then col_gas (ngas+1, *S) and the
        interpolation coefficients of one call in one kernel launch on
        CUDA (``ops/kernels/gas_descriptors``), contiguous in the layout
        asked (S = (nlay, ncol) with ``layer_major``, else (ncol, nlay)),
        and the h2o row."""
        self._check_key_species_present(gas_concs)
        vmrs, idx_h2o = vmr_rows(self.kdist, gas_concs, *play.shape)
        if col_dry is not None:
            col_dry = torch.as_tensor(col_dry, dtype=play.dtype,
                                      device=play.device)
        col_gas, co = gas_descriptors(play, tlay, plev, vmrs, col_dry,
                                      idx_h2o, self.interp_tables[play.dtype],
                                      layer_major)
        return col_gas, co, idx_h2o

    @trace.spanned("gas.minor_scaling")
    def _minor_scale(self, co, play, tlay, col_gas, idx_h2o: int):
        """The scaling rows of every minor window, lower first ((nminor,
        *S), one kernel launch on CUDA; ``ops/kernels/minor_scale``)."""
        return minor_scale(co.tropo, play, tlay, col_gas, idx_h2o,
                           self.minor_windows, self.minor_scale_table)

    def interp(self, play, tlay, col_gas) -> InterpCoeffs:
        """The interpolation coefficients of ``col_gas``'s cells (the
        plain twin of the kernel's, :meth:`_gas_descriptors`)."""
        return interpolation(play, tlay, col_gas,
                             self.interp_tables[play.dtype])

    # ------------------------------------------------------------------
    # the public API
    # ------------------------------------------------------------------
    def _taus(self, play, plev, tlay, gas_concs, col_dry, scattering: bool,
              split_rayleigh: bool = False):
        """compute_gas_taus (reference :419-745) on (ncol, nlay) cells:
        major-gas absorption and Planck fraction, the minor gases of each
        atmosphere, and Rayleigh, each through its kernel wrapper with its
        twin's gradient (the JAX _compute_taus, gas_optics.py:154-206).
        Returns
        (tau, second, pfrac or None), each (ncol, nlay, ngpt): ``second``
        is the Rayleigh ssa with the absorption/Rayleigh combine (reference
        combine_abs_and_rayleigh :1954-2036) with ``scattering``, None
        without; with ``split_rayleigh``, tau is the absorption alone and
        ``second`` the Rayleigh optical depth (zero without krayl)."""
        kd = self.kdist
        with trace.span("gas.descriptors"):
            col_gas, co, idx_h2o = self._gas_descriptors(
                play, plev, tlay, gas_concs, col_dry, layer_major=False)
        col_dry = col_gas[0]
        tau, pfrac = _major(co, kd.kmajor, kd.planck_frac,
                            self.gpoint_flavor, self.kmajor_pfrac)
        nlo = len(kd.minor_lower)
        minors_lo, minors_up = _split_minors(self.minors)
        msc = self._minor_scale(co, play, tlay, col_gas, idx_h2o)
        for ktab, minors, meta, scaling in (
                (kd.kminor_lower, minors_lo, self.minor_meta[:nlo],
                 msc[:nlo]),
                (kd.kminor_upper, minors_up, self.minor_meta[nlo:],
                 msc[nlo:])):
            if minors:
                tau = _minor(tau, co, ktab, minors, meta, scaling)
        if kd.krayl is None:
            second = (torch.zeros_like(tau) if scattering or split_rayleigh
                      else None)
            return tau, second, pfrac
        rayl = (co, kd.krayl, self.gpoint_flavor, col_gas[idx_h2o] + col_dry)
        if split_rayleigh:
            # 0 + Rayleigh: the Rayleigh optical depth alone
            ray, _ = _rayleigh(None, *rayl, False)
            return tau, ray, pfrac
        tau, ssa = _rayleigh(tau, *rayl, scattering)
        return tau, ssa, pfrac

    def _compute_taus(self, play, plev, tlay, gas_concs, col_dry,
                      top_at_1: bool, scattering: bool):
        """:meth:`_taus` as optical properties: (props, pfrac or None)."""
        tau, ssa, pfrac = self._taus(play, plev, tlay, gas_concs, col_dry,
                                     scattering)
        if not scattering:
            return OpticalProps1scl(tau=tau, grid=self.grid,
                                    top_at_1=top_at_1), pfrac
        return OpticalProps2str(tau=tau, ssa=ssa, g=torch.zeros_like(tau),
                                grid=self.grid, top_at_1=top_at_1), pfrac

    def gas_optics_lw(self, play, plev, tlay, tsfc, gas_concs: GasConcs, *,
                      tlev=None, col_dry=None, scattering: bool = False,
                      top_at_1=None):
        """LW optical depths and Planck sources (reference
        gas_optics_int): play/tlay (ncol, nlay), plev/tlev (ncol, nlay+1),
        tsfc (ncol,). Returns (OpticalProps1scl, or 2str with
        ``scattering``, and SourcesLW). The vertical orientation is
        ``top_at_1`` or inferred from the pressures."""
        if not self.source_is_internal():
            raise ValueError("rrtmgp gas optics: k-distribution is SW "
                             "(external source)")
        kd = self.kdist
        play, plev, tlay = (x.contiguous() for x in (play, plev, tlay))
        tsfc = torch.as_tensor(tsfc, dtype=play.dtype, device=play.device)
        top = infer_top_at_1(play, top_at_1)
        props, pfrac = self._compute_taus(play, plev, tlay, gas_concs,
                                          col_dry, top, scattering)
        tlev = interp_tlev(tlay, play, plev) if tlev is None else tlev
        sfc, lay, lev, jac = planck_sources(
            pfrac, totplnk=kd.totplnk, totplnk_delta=kd.totplnk_delta,
            temp_ref_min=kd.temp_ref_min, gpt2band=kd.grid.gpt2band,
            tlay=tlay, tlev=tlev, tsfc=tsfc, top_at_1=top)
        return props, SourcesLW(lay_source=lay, lev_source=lev,
                                sfc_source=sfc, sfc_source_jac=jac,
                                grid=self.grid)

    def gas_optics_sw(self, play, plev, tlay, gas_concs: GasConcs, *,
                      col_dry=None, scattering: bool = True, top_at_1=None):
        """SW optical depths and the TOA solar source (reference
        gas_optics_ext). Returns (OpticalProps2str, or 1scl without
        ``scattering``, and the incident flux (ncol, ngpt))."""
        if not self.source_is_external():
            raise ValueError("rrtmgp gas optics: k-distribution is LW "
                             "(internal source)")
        play, plev, tlay = (x.contiguous() for x in (play, plev, tlay))
        top = infer_top_at_1(play, top_at_1)
        props, _ = self._compute_taus(play, plev, tlay, gas_concs, col_dry,
                                      top, scattering)
        toa = self.kdist.solar_source.to(play.dtype)[None, :].expand(
            play.shape[0], self.ngpt)
        return props, toa

    # ------------------------------------------------------------------
    # the staged lane-layout branch (JAX gas_optics.py:438-494): the same
    # kernels as the public API, returned as (ngpt, nlay, ncol) views, top
    # at layer 0
    # ------------------------------------------------------------------
    def gas_optics_lw_lanes(self, play, plev, tlay, tsfc, gas_concs, *,
                            tlev=None, col_dry=None,
                            banded_planck: bool = False):
        """LW optical depths and Planck sources for the lane solvers:
        (tau, (sfc_src, lay_src, lev_src, sfc_src_jac)), or with
        ``banded_planck`` (tau, pfrac, (pb_sfc (nbnd, ncol), pb_lay
        (nbnd, nlay, ncol), pb_lev (nbnd, nlay+1, ncol))) for the solver
        that forms the sources itself. Spectral fields are (ngpt, nlay[+1],
        ncol) and boundary fields (ngpt, ncol): permuted views of the
        gathers' (ncol, nlay, ngpt) output, not copies."""
        if not self.source_is_internal():
            raise ValueError("rrtmgp gas optics: k-distribution is SW")
        kd = self.kdist
        play, plev, tlay = (x.contiguous() for x in (play, plev, tlay))
        tsfc = torch.as_tensor(tsfc, dtype=play.dtype, device=play.device)
        tau, _, pfrac = self._taus(play, plev, tlay, gas_concs, col_dry,
                                   scattering=False)
        tlev = interp_tlev(tlay, play, plev) if tlev is None else tlev
        lane = lambda x: x.permute(2, 1, 0)
        if banded_planck:
            pb = lambda t: planck_bands_lanes(
                t, totplnk=kd.totplnk, totplnk_delta=kd.totplnk_delta,
                temp_ref_min=kd.temp_ref_min)
            return lane(tau), lane(pfrac), (pb(tsfc), pb(tlay.T),
                                            pb(tlev.T))
        sfc, lay, lev, jac = planck_sources(
            pfrac, totplnk=kd.totplnk, totplnk_delta=kd.totplnk_delta,
            temp_ref_min=kd.temp_ref_min, gpt2band=kd.grid.gpt2band,
            tlay=tlay, tlev=tlev, tsfc=tsfc, top_at_1=True)
        return lane(tau), (sfc.T, lane(lay), lane(lev), jac.T)

    def gas_optics_sw_lanes(self, play, plev, tlay, gas_concs, *,
                            col_dry=None, split_rayleigh: bool = False):
        """SW (tau, ssa, toa) for the lane solvers, tau/ssa (ngpt, nlay,
        ncol) views and toa (ngpt, ncol); with ``split_rayleigh``, (tau of
        absorption, tau of Rayleigh, toa) for the solver that combines
        them itself."""
        if not self.source_is_external():
            raise ValueError("rrtmgp gas optics: k-distribution is LW")
        play, plev, tlay = (x.contiguous() for x in (play, plev, tlay))
        tau, second, _ = self._taus(play, plev, tlay, gas_concs, col_dry,
                                    scattering=True,
                                    split_rayleigh=split_rayleigh)
        lane = lambda x: x.permute(2, 1, 0)
        toa = self.kdist.solar_source.to(play.dtype)[:, None].expand(
            self.ngpt, play.shape[0])
        return lane(tau), lane(second), toa

    def compute_optimal_angles(self, props: OpticalProps) -> torch.Tensor:
        """Per-(column, g-point) LW secants from the total-column
        transmittance (reference compute_optimal_angles :1503-1562, Hogan
        fits), for ``rte_lw(lw_ds=...)``: (ncol, ngpt)."""
        kd = self.kdist
        if kd.optimal_angle_fit is None:
            raise ValueError("compute_optimal_angles: no fit coefficients "
                             "loaded")
        if not kd.grid.gpoints_are_equal(props.grid):
            raise ValueError("compute_optimal_angles: spectral "
                             "discretization mismatch")
        trans_total = torch.exp(-props.tau.sum(1))
        fit = torch.as_tensor(kd.optimal_angle_fit, dtype=props.tau.dtype,
                              device=props.tau.device)
        band = self.gpt2band.long()
        return fit[0, band][None] * trans_total + fit[1, band][None]

    # ------------------------------------------------------------------
    # the fused kernels' inputs
    # ------------------------------------------------------------------
    @trace.spanned("gas.descriptors")
    def _descriptors(self, play, plev, tlay, gas_concs, col_dry=None):
        """Layer-major interpolation state and minor scaling rows: (co,
        minor_scale, col_gas, col_dry, idx_h2o), each contiguous (nlay,
        ncol) cells."""
        col_gas, co, idx_h2o = self._gas_descriptors(
            play, plev, tlay, gas_concs, col_dry, layer_major=True)
        msc = self._minor_scale(co, play.T, tlay.T, col_gas, idx_h2o)
        return co, msc, col_gas, col_gas[0], idx_h2o

    def _check_byband(self, byband: bool) -> None:
        """The fused solves' by-band output needs uniform band widths (the
        JAX package's rule, models/rrtmgp/gas_optics.py:42-50)."""
        lims = np.asarray(self.kdist.grid.band_lims_gpt_array)
        widths = lims[:, 1] - lims[:, 0] + 1
        if byband and not (widths == widths[0]).all():
            raise ValueError("fused by-band path requires uniform band "
                             f"widths; got {widths.tolist()}")

    @trace.spanned("gas.fused_inputs")
    def lw_fused_inputs(self, play, plev, tlay, tsfc, gas_concs, *,
                        sfc_emis, inc_flux=None, tlev=None, col_dry=None,
                        cloud_tau_abs=None, ds, weight,
                        byband: bool = False) -> LWFusedInputs:
        """Descriptor prep for the fused LW kernel. sfc_emis and inc_flux
        (ngpt, ncol), the incident flux zero when None; col_dry optional
        (ncol, nlay) dry-air columns; cloud_tau_abs optional (nbnd, nlay,
        ncol) by-band absorption; ``byband`` asks for per-band sums."""
        kd = self.kdist
        if not kd.source_is_internal():
            raise ValueError("rrtmgp gas optics: k-distribution is SW")
        self._check_byband(byband)
        co, msc, _, _, _ = self._descriptors(play, plev, tlay, gas_concs,
                                             col_dry)
        if tlev is None:
            tlev = interp_tlev(tlay, play, plev)
        if inc_flux is None:
            inc_flux = play.new_zeros(()).expand(kd.ngpt, play.shape[0])
        return LWFusedInputs(
            co=co, minor_scale=msc, minors=self.minors,
            minor_meta=self.minor_meta, kmajor=kd.kmajor,
            planck_frac=kd.planck_frac, kminor_lower=kd.kminor_lower,
            kminor_upper=kd.kminor_upper, gpoint_flavor=self.gpoint_flavor,
            gpt2band=self.gpt2band, totplnk=kd.totplnk,
            tp_min=kd.temp_ref_min, tp_delta=kd.totplnk_delta,
            tlay=tlay.T.contiguous(), tlev=tlev.T.contiguous(),
            tsfc=tsfc.to(play.dtype).contiguous(),
            sfc_emis=sfc_emis.contiguous(), inc=inc_flux.contiguous(),
            cloud_tau_abs=cloud_tau_abs, ds=float(ds), weight=float(weight),
            byband=bool(byband), kmajor_pfrac=self.kmajor_pfrac)

    def lw_fused_solve(self, play, plev, tlay, tsfc, gas_concs, **kw):
        """Gas optics + no-scattering solve in one fused kernel call
        (keywords of :meth:`lw_fused_inputs`). Returns (flux_up, flux_dn):
        broadband, each (nlay+1, ncol), or by band, (nbnd, nlay+1,
        ncol)."""
        return lw_fused(self.lw_fused_inputs(play, plev, tlay, tsfc,
                                             gas_concs, **kw))

    @trace.spanned("gas.fused_inputs")
    def sw_fused_inputs(self, play, plev, tlay, gas_concs, *, mu0,
                        sfc_alb_dir, sfc_alb_dif, inc_flux=None,
                        inc_flux_dif=None, col_dry=None, cloud=None,
                        byband: bool = False) -> SWFusedInputs:
        """Descriptor prep for the fused SW kernel. mu0 (nlay, ncol);
        sfc_alb_*, inc_flux and inc_flux_dif (ngpt, ncol): the direct TOA
        flux the k-distribution's solar source when None, the diffuse one
        zero; col_dry optional (ncol, nlay) dry-air columns; cloud
        optional by-band delta-scaled (tau, ssa, g), each (nbnd, nlay,
        ncol); ``byband`` asks for per-band sums."""
        kd = self.kdist
        if not kd.source_is_external():
            raise ValueError("rrtmgp gas optics: k-distribution is LW")
        self._check_byband(byband)
        co, msc, col_gas_c, col_dry_c, idx_h2o = self._descriptors(
            play, plev, tlay, gas_concs, col_dry)
        if cloud is not None:
            cloud = torch.stack(cloud)
            if cloud.shape[1] != kd.grid.nband:
                raise ValueError(f"sw cloud has {cloud.shape[1]} bands, the "
                                 f"k-distribution {kd.grid.nband}")
        if inc_flux is None:
            inc_flux = kd.solar_source.to(play.dtype)[:, None].expand(
                kd.ngpt, play.shape[0])
        return SWFusedInputs(
            co=co, minor_scale=msc, minors=self.minors,
            minor_meta=self.minor_meta, kmajor=kd.kmajor,
            kminor_lower=kd.kminor_lower, kminor_upper=kd.kminor_upper,
            krayl=kd.krayl, gpoint_flavor=self.gpoint_flavor,
            gpt2band=self.gpt2band,
            rayscale=(col_gas_c[idx_h2o] + col_dry_c).contiguous(),
            cloud=cloud, mu0=mu0.contiguous(),
            sfc_alb_dir=sfc_alb_dir.contiguous(),
            sfc_alb_dif=sfc_alb_dif.contiguous(), inc=inc_flux.contiguous(),
            incdif=(None if inc_flux_dif is None
                    else inc_flux_dif.contiguous()),
            byband=bool(byband), nband=kd.grid.nband)

    def sw_fused_solve(self, play, plev, tlay, gas_concs, **kw):
        """Gas optics + two-stream solve in one fused kernel call
        (keywords of :meth:`sw_fused_inputs`). Returns (flux_up, flux_dn
        total, flux_dir): broadband, each (nlay+1, ncol), or by band,
        (nbnd, nlay+1, ncol)."""
        return sw_fused(self.sw_fused_inputs(play, plev, tlay, gas_concs,
                                             **kw))
