"""Top-level RTE drivers: ``rte_lw`` and ``rte_sw``.

Counterpart of ``rte_rrtmgp_tpu.rte`` (reference rte/frontend/
mo_rte_lw.F90:79-473 and mo_rte_sw.F90:56-394): check the inputs, expand
band boundary conditions to g-points, dispatch on the optical-props
flavor and reduce the fluxes. Broadband and by-band fluxes go through the
solver kernels (``ops/kernels/solver_lw``, ``solver_lw_2str``,
``solver_sw``: the CUDA kernel on a CUDA tensor, its plain twin on a CPU
one), which sum each band's g-points through ``gpt2band``, so uniform and
ragged bands take the same route; ``spectral=True`` is plain tensor code
on any device. Boundary fields are column-leading, (ncol, 1), (ncol,
nband) or (ncol, ngpt), and are cast to the optical properties' dtype and
device.
"""
from __future__ import annotations

import torch

from . import trace
from .config import get_config
from .fluxes import Fluxes, sum_byband
from .optical_props import (OpticalProps, OpticalProps1scl, OpticalProps2str,
                            OpticalPropsNstr, validate as validate_props)
from .ops.solver_lw import (GAUSS_DS, GAUSS_WTS, lw_solver_2stream,
                            lw_solver_noscat)
from .ops.solver_sw import sw_solver_2stream, sw_solver_noscat
from .sources import SourcesLW

__all__ = ["rte_lw", "rte_sw"]


def _bands(byband: bool, grid, like) -> dict:
    """The solvers' by-band keywords: each g-point's 0-based band as int32
    on ``like``'s device and the band count, or nothing for broadband."""
    if not byband:
        return {}
    return dict(gpt2band=torch.as_tensor(grid.gpt2band, dtype=torch.int32,
                                         device=like.device),
                nband=grid.nband)


def _expand_bc(arr, grid, ncol, what, like):
    """A boundary field given per band, per g-point or as one value per
    column, as a contiguous (ncol, ngpt) tensor of ``like``'s dtype and
    device."""
    arr = torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    if arr.ndim != 2 or arr.shape[0] != ncol:
        raise ValueError(f"rte: {what} must be (ncol, nband) or (ncol, ngpt);"
                         f" got {tuple(arr.shape)}")
    if arr.shape[1] == grid.ngpt:
        return arr.contiguous()
    if arr.shape[1] == 1:
        return arr.expand(ncol, grid.ngpt).contiguous()
    if arr.shape[1] == grid.nband:
        band = torch.as_tensor(grid.gpt2band, dtype=torch.long,
                               device=like.device)
        return arr.index_select(1, band)
    raise ValueError(f"rte: {what} has {arr.shape[1]} spectral points; "
                     f"expected nband={grid.nband} or ngpt={grid.ngpt}")


@trace.spanned("rte.lw")
def rte_lw(optical_props: OpticalProps, sources: SourcesLW, sfc_emis, *,
           inc_flux=None, n_gauss_angles: int = 1, use_2stream: bool = False,
           lw_ds=None, compute_jacobian: bool = False,
           spectral: bool = False, byband: bool = False) -> Fluxes:
    """Longwave fluxes (reference ``rte_lw``, mo_rte_lw.F90:79-473).

    1scl props: no-scattering solve with 1-4 Gauss-Jacobi angles, or the
    per-(column, g-point) secants ``lw_ds``. 2str props: the Tang-rescaled
    no-scattering solve, or with ``use_2stream`` the true two-stream solve
    (no Jacobian). ``compute_jacobian`` adds d(flux_up)/dT_sfc, broadband
    at every flux resolution but the spectral one. ``spectral`` returns
    (ncol, nlev, ngpt) fluxes, ``byband`` per-band sums (ncol, nlev,
    nband)."""
    grid = optical_props.grid
    tau = optical_props.tau
    ncol, nlay, ngpt = tau.shape
    if tuple(sources.lay_source.shape) != (ncol, nlay, ngpt):
        raise ValueError(f"rte_lw: sources lay_source shape "
                         f"{tuple(sources.lay_source.shape)} != "
                         f"{(ncol, nlay, ngpt)}")
    if tuple(sources.lev_source.shape) != (ncol, nlay + 1, ngpt):
        raise ValueError("rte_lw: sources lev_source inconsistently sized")
    if not 1 <= n_gauss_angles <= len(GAUSS_DS):
        raise ValueError(f"rte_lw: n_gauss_angles must be in "
                         f"1..{len(GAUSS_DS)}")
    if isinstance(optical_props, OpticalPropsNstr):
        raise NotImplementedError("rte_lw: n-stream solver not yet "
                                  "implemented")
    if use_2stream and isinstance(optical_props, OpticalProps1scl):
        raise ValueError("rte_lw: can't use two-stream methods with only "
                         "absorption optical depth")
    if use_2stream and compute_jacobian:
        raise ValueError("rte_lw: can't provide Jacobian of fluxes with "
                         "2-stream")
    if lw_ds is not None:
        if not isinstance(optical_props, OpticalProps1scl):
            raise ValueError("rte_lw: lw_ds not valid when providing "
                             "scattering optical properties")
        if n_gauss_angles != 1:
            raise ValueError("rte_lw: providing lw_ds incompatible with "
                             "specifying n_gauss_angles")
    if byband and spectral:
        raise ValueError("rte_lw: byband and spectral are mutually exclusive")
    if get_config().check_values:
        validate_props(optical_props)

    emis = _expand_bc(sfc_emis, grid, ncol, "sfc_emis", tau)
    inc = (torch.zeros((ncol, ngpt), dtype=tau.dtype, device=tau.device)
           if inc_flux is None
           else _expand_bc(inc_flux, grid, ncol, "inc_flux", tau))
    bands = _bands(byband, grid, tau)
    if use_2stream:
        res = lw_solver_2stream(
            tau, optical_props.ssa, optical_props.g, sources.lay_source,
            sources.lev_source, emis, sources.sfc_source, inc,
            top_at_1=optical_props.top_at_1, spectral=spectral, **bands)
    else:
        if lw_ds is not None:
            ds = (torch.as_tensor(lw_ds, dtype=tau.dtype, device=tau.device)
                  .expand(ncol, ngpt).contiguous(),)
            weights = GAUSS_WTS[0]
        else:
            ds, weights = GAUSS_DS[n_gauss_angles - 1], \
                GAUSS_WTS[n_gauss_angles - 1]
        rescale = isinstance(optical_props, OpticalProps2str)
        res = lw_solver_noscat(
            tau, sources.lay_source, sources.lev_source, emis,
            sources.sfc_source, inc, top_at_1=optical_props.top_at_1, ds=ds,
            weights=weights, sfc_src_jac=sources.sfc_source_jac,
            ssa=optical_props.ssa if rescale else None,
            g=optical_props.g if rescale else None, do_rescaling=rescale,
            do_jacobians=compute_jacobian, spectral=spectral, **bands)
    up, dn = res.flux_up, res.flux_dn
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up,
                  flux_up_jac=res.flux_up_jac)


@trace.spanned("rte.sw")
def rte_sw(optical_props: OpticalProps, mu0, inc_flux, sfc_alb_dir,
           sfc_alb_dif, *, inc_flux_dif=None, spectral: bool = False,
           byband: bool = False) -> Fluxes:
    """Shortwave fluxes (reference ``rte_sw``, mo_rte_sw.F90:56-394).

    mu0: cosine of the solar zenith angle, (ncol,) or (ncol, nlay) for
    spherical geometry. inc_flux: direct-beam incident flux. 1scl props:
    the direct beam only; 2str props: two-stream + adding, with the
    diffuse incident flux ``inc_flux_dif``."""
    if byband and spectral:
        raise ValueError("rte_sw: byband and spectral are mutually exclusive")
    grid = optical_props.grid
    tau = optical_props.tau
    ncol, nlay, ngpt = tau.shape
    top_at_1 = optical_props.top_at_1
    mu0 = torch.as_tensor(mu0, dtype=tau.dtype, device=tau.device)
    if mu0.ndim == 1:
        mu0 = mu0[:, None].expand(ncol, nlay)
    elif tuple(mu0.shape) != (ncol, nlay):
        raise ValueError(f"rte_sw: mu0 shape {tuple(mu0.shape)} != (ncol,) "
                         "or (ncol, nlay)")
    mu0 = mu0.contiguous()
    if get_config().check_values:
        validate_props(optical_props)
        with trace.span("check.mu0"), trace.wait("mu0"):
            bad = bool(((mu0 < -1.0) | (mu0 > 1.0)).any())
        if bad:
            raise ValueError("rte_sw: one or more mu0 < -1 or > 1")

    inc = _expand_bc(inc_flux, grid, ncol, "inc_flux", tau)
    if isinstance(optical_props, OpticalProps1scl):
        if inc_flux_dif is not None:
            raise ValueError(
                "rte_sw: inc_flux_dif requires scattering optical properties"
                " (the absorption-only solver computes the direct beam only)")
        flux_dir = sw_solver_noscat(tau, mu0, inc, top_at_1=top_at_1)
        if byband:
            flux_dir = sum_byband(flux_dir, grid)
        elif not spectral:
            flux_dir = flux_dir.sum(-1)
        zeros = torch.zeros_like(flux_dir)
        return Fluxes(flux_up=zeros, flux_dn=flux_dir, flux_net=flux_dir,
                      flux_dn_dir=flux_dir)
    if isinstance(optical_props, OpticalPropsNstr):
        raise NotImplementedError("rte_sw: n-stream solver not yet "
                                  "implemented")
    alb_dir = _expand_bc(sfc_alb_dir, grid, ncol, "sfc_alb_dir", tau)
    alb_dif = _expand_bc(sfc_alb_dif, grid, ncol, "sfc_alb_dif", tau)
    dif = (None if inc_flux_dif is None
           else _expand_bc(inc_flux_dif, grid, ncol, "inc_flux_dif", tau))
    res = sw_solver_2stream(tau, optical_props.ssa, optical_props.g, mu0,
                            alb_dir, alb_dif, inc, top_at_1=top_at_1,
                            inc_flux_dif=dif, spectral=spectral,
                            **_bands(byband, grid, tau))
    up, dn, fdir = res.flux_up, res.flux_dn, res.flux_dir
    return Fluxes(flux_up=up, flux_dn=dn, flux_net=dn - up, flux_dn_dir=fdir)
