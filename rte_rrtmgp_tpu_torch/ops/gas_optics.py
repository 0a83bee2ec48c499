"""RRTMGP correlated-k gas-optics numerics on tensors (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.ops.gas_optics`` (reference kernels
rrtmgp/kernels/mo_gas_optics_rrtmgp_kernels.F90): ``interpolation``
(:37-170), the major/minor absorption (:345-501), Rayleigh (:506-565) and
the Planck source (:568-710). These are the building blocks of the
kernels' plain twins.

Conventions: cell arrays have any shape ``S`` (the fused kernels use
layer-major ``(nlay, ncol)``, the public API ``(ncol, nlay)``); the
lookups' spectral outputs are ``(ngpt, *S)``, g-points leading;
:func:`planck_sources` works in the public layout, and
:func:`planck_bands_lanes` gives the band values with the band leading.
Tables are the KDist's plain layouts; indices are 0-based.
  col_gas  (ngas+1, *S), dry air at index 0
  jeta, col_mix, feta  (2, nflav, *S), axis 0 = temperature corner
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants, trace

__all__ = ["InterpCoeffs", "InterpTables", "interp_tables", "get_col_dry",
           "column_amounts", "interpolation", "tau_major", "tau_minor",
           "minor_scaling", "window_rows", "scaling_rows", "tau_rayleigh",
           "interp1d_table", "planck_sources", "planck_bands_lanes",
           "level_pfrac"]


class InterpCoeffs(NamedTuple):
    jtemp: torch.Tensor     # (*S) int32, lower temperature index
    ftemp: torch.Tensor     # (*S)
    jpress: torch.Tensor    # (*S) int32, lower pressure index
    fpress: torch.Tensor    # (*S)
    tropo: torch.Tensor     # (*S) bool, True = lower atmosphere
    jeta: torch.Tensor      # (2, nflav, *S) int32
    col_mix: torch.Tensor   # (2, nflav, *S)
    feta: torch.Tensor      # (2, nflav, *S)


class InterpTables(NamedTuple):
    """What the interpolation reads of a k-distribution, made once per
    k-distribution and dtype (:func:`interp_tables`): the device tables
    and the scalars, as the reference's ``rrtmgp_interpolation`` takes
    them."""
    temp_ref: torch.Tensor     # (ntemp,)
    vmr_ratio: torch.Tensor    # (2, nflav, ntemp): vmr_ref of g1 over g2
    flavor: torch.Tensor       # (2, nflav) int64, rows of col_gas
    trop: float                # the tropopause pressure, exp of its log
    neta: int
    npres: int
    press_ref_log0: float
    press_ref_log_delta: float
    temp_ref_min: float
    temp_ref_delta: float


def interp_tables(kdist, dtype, device) -> InterpTables:
    """The interpolation's tables of ``kdist`` in ``dtype`` on ``device``:
    the only host-to-device copies the interpolation needs, made here
    once."""
    g1, g2 = np.asarray(kdist.flavor[0]), np.asarray(kdist.flavor[1])
    vmr_ref = np.asarray(kdist.vmr_ref)
    return InterpTables(
        temp_ref=torch.as_tensor(np.ascontiguousarray(kdist.temp_ref),
                                 dtype=dtype, device=device),
        vmr_ratio=torch.as_tensor(np.ascontiguousarray(
            vmr_ref[:, g1, :] / vmr_ref[:, g2, :]), dtype=dtype,
            device=device),
        flavor=torch.as_tensor(np.stack([g1, g2]), dtype=torch.int64,
                               device=device),
        trop=float(torch.exp(torch.tensor(kdist.press_ref_trop_log,
                                          dtype=dtype))),
        neta=int(kdist.neta), npres=int(kdist.press_ref_log.shape[0]),
        press_ref_log0=float(kdist.press_ref_log[0]),
        press_ref_log_delta=float(kdist.press_ref_log_delta),
        temp_ref_min=float(kdist.temp_ref_min),
        temp_ref_delta=float(kdist.temp_ref_delta))


def get_col_dry(vmr_h2o, plev):
    """Dry-air molecules per cm^2 per layer (reference
    ``get_layer_number``, rte/kernels/mo_gas_optics_utils.F90:127-152)."""
    delta_plev = torch.abs(plev[:, :-1] - plev[:, 1:])
    fact = 1.0 / (1.0 + vmr_h2o)
    m_air = (constants.m_dry + constants.m_h2o * vmr_h2o) * fact
    return (10.0 * delta_plev * constants.avogad * fact
            / (1000.0 * m_air * 100.0 * constants.grav))


@trace.spanned("gas.col_gas")
def column_amounts(play, plev, vmrs, col_dry=None, idx_h2o: int = 1):
    """Column amounts (reference compute_gas_taus :538-609): (ngas+1,
    ncol, nlay) with row 0 col_dry and row i vmrs[i-1] * col_dry. ``vmrs``
    holds a tensor (a scalar, a (nlay,) profile or an (ncol, nlay) field)
    or None (the gas is absent: zeros) per row; col_dry is computed from
    the pressures and row ``idx_h2o``'s vmr unless given."""
    dtype = play.dtype
    vmrs = [torch.zeros_like(play) if v is None else v.to(dtype)
            for v in vmrs]
    if col_dry is None:
        col_dry = get_col_dry(vmrs[idx_h2o - 1], plev)
    col_dry = torch.as_tensor(col_dry, dtype=dtype, device=play.device)
    return torch.stack([col_dry] + [v * col_dry for v in vmrs])


@trace.spanned("gas.interp")
def interpolation(play, tlay, col_gas, tables: InterpTables) -> InterpCoeffs:
    """Temperature/pressure/eta interpolation coefficients (reference
    ``rrtmgp_interpolation``, kernels :37-170) from the k-distribution's
    :func:`interp_tables`, already on the cells' device. Each index and
    its fraction derive from ONE computed value (eager PyTorch
    materializes it once), so an index never pairs with the other side's
    fraction."""
    t = tables
    dtype = play.dtype
    ntemp = t.temp_ref.shape[0]

    # temperature (reference :106-108); ftemp anchors at the CLAMPED node
    loctemp = (tlay - (t.temp_ref_min - t.temp_ref_delta)) / t.temp_ref_delta
    jtemp1 = torch.clamp(torch.floor(loctemp).to(torch.int32), 1, ntemp - 1)
    ftemp = (tlay - t.temp_ref[jtemp1.long() - 1]) / t.temp_ref_delta
    jtemp = jtemp1 - 1

    # pressure (reference :111-114)
    locpress = 1.0 + (torch.log(play) - t.press_ref_log0) \
        / t.press_ref_log_delta
    jpress_f = torch.clamp(torch.trunc(locpress), 1.0, float(t.npres - 1))
    fpress = locpress - jpress_f
    jpress = jpress_f.to(torch.int32) - 1

    tropo = play > t.trop

    # eta per flavor and reference temperature (reference :121-168)
    neta = t.neta
    tiny = torch.finfo(dtype).tiny
    cg1 = col_gas[t.flavor[0]]                           # (nflav, *S)
    cg2 = col_gas[t.flavor[1]]
    cms, jes, fes = [], [], []
    for it in (0, 1):
        jt_i = torch.clamp(jtemp + it, 0, ntemp - 1).long()
        r = torch.where(tropo, t.vmr_ratio[0][:, jt_i],
                        t.vmr_ratio[1][:, jt_i])
        cm = cg1 + r * cg2
        big = cm > 2.0 * tiny
        eta = torch.where(big, cg1 / torch.where(big, cm, 1.0), 0.5)
        loceta = eta * (neta - 1)
        trunc_loceta = torch.trunc(loceta)
        jes.append(torch.clamp(trunc_loceta.to(torch.int32) + 1,
                               max=neta - 1) - 1)
        fes.append(loceta - trunc_loceta)
        cms.append(cm)
    return InterpCoeffs(jtemp=jtemp, ftemp=ftemp, jpress=jpress,
                        fpress=fpress, tropo=tropo, jeta=torch.stack(jes),
                        col_mix=torch.stack(cms), feta=torch.stack(fes))


def _weights(co: InterpCoeffs, gpoint_flavor):
    """Per-(g-point, cell) row pieces shared by the major and Rayleigh
    lookups: jeta (2, ngpt, *S) and its eta fraction, and col_mix."""
    dev = co.jtemp.device
    gf = torch.as_tensor(gpoint_flavor, device=dev).long()
    pick = lambda x: torch.stack([
        torch.where(co.tropo, x[it][gf[0]], x[it][gf[1]]) for it in (0, 1)])
    return pick(co.jeta).long(), pick(co.feta), pick(co.col_mix)


def tau_major(co: InterpCoeffs, kmajor, planck_frac, gpoint_flavor):
    """Major-gas optical depth (reference gas_optical_depths_major /
    interpolate3D_byflav, kernels :345-396, :765-803) and, when
    ``planck_frac`` is given, the Planck fraction from the same corners
    (:619-634). The upper atmosphere reads the pressure row above its
    index (``jp_base = jpress + (0 if tropo else 1)``). Returns
    (tau, pfrac or None), each (ngpt, *S)."""
    ntemp, neta, npres1, ngpt = kmajor.shape
    je, fe, cm = _weights(co, gpoint_flavor)
    g = torch.arange(ngpt, device=kmajor.device).view(
        (-1,) + (1,) * co.jtemp.ndim)
    jt = co.jtemp.long()
    jp = (co.jpress + torch.where(co.tropo, 0, 1)).long()
    ft = (1.0 - co.ftemp, co.ftemp)
    fp = (1.0 - co.fpress, co.fpress)
    kflat = kmajor.reshape(-1)
    pflat = None if planck_frac is None else planck_frac.reshape(-1)
    tau = pf = None
    for it in (0, 1):
        fe_c = (1.0 - fe[it], fe[it])
        for dp in (0, 1):
            for de in (0, 1):
                wgt = (fe_c[de] * ft[it]) * fp[dp]
                row = (((jt + it) * neta + je[it] + de) * npres1 + jp + dp)
                flat = row * ngpt + g
                t = (wgt * cm[it]) * kflat[flat]
                tau = t if tau is None else tau + t
                if pflat is not None:
                    p = wgt * pflat[flat]
                    pf = p if pf is None else pf + p
    return tau, pf


def window_rows(mset, lower: bool) -> tuple:
    """One (lower, idx_minor, scales_with_density, idx_minor_scaling,
    scale_by_complement) row of ints per minor window of ``mset``, the
    atmosphere's: what :func:`scaling_rows` reads of a window."""
    return tuple((int(lower), int(mset.idx_minor[m]),
                  int(bool(mset.scales_with_density[m])),
                  int(mset.idx_minor_scaling[m]),
                  int(bool(mset.scale_by_complement[m])))
                 for m in range(len(mset.kminor_start)))


def scaling_rows(tropo, play, tlay, col_gas, idx_h2o: int, windows):
    """The scaling row of each window of :func:`window_rows` (either
    atmosphere's, in any order) with its atmosphere mask applied
    (reference gas_optical_depths_minor :461-480): (len(windows), *S)."""
    dtype = play.dtype
    masks = {}
    inv_col_dry = 1.0 / col_gas[0]
    dry_fact = 1.0 / (1.0 + col_gas[idx_h2o] * inv_col_dry)
    rows = []
    for lower, idx, density, isc, complement in windows:
        scaling = col_gas[idx]
        if density:
            scaling = scaling * (0.01 * play / tlay)
            if isc > 0:
                frac = col_gas[isc] * inv_col_dry * dry_fact
                scaling = scaling * ((1.0 - frac) if complement else frac)
        if lower not in masks:
            masks[lower] = (tropo if lower else ~tropo).to(dtype)
        rows.append(scaling * masks[lower])
    if not rows:
        return play.new_zeros((0,) + tuple(play.shape))
    return torch.stack(rows)


def minor_scaling(co: InterpCoeffs, mset, *, lower: bool, play, tlay,
                  col_gas, idx_h2o: int):
    """Per-minor-gas scaling rows of one atmosphere with its mask applied
    (reference gas_optical_depths_minor :461-480): (nminor, *S)."""
    return scaling_rows(co.tropo, play, tlay, col_gas, idx_h2o,
                        window_rows(mset, lower))


def tau_minor(tau, co: InterpCoeffs, kminor, minors, scaling):
    """Add one atmosphere's minor-gas optical depths into ``tau``
    (reference gas_optical_depths_minor, kernels :402-501). ``minors``:
    one (flavor, g0, width, kminor_start) per minor gas, all 0-based;
    ``scaling``: their rows from :func:`minor_scaling`. Each adds a 2-D
    (temperature x eta) lerp of kminor over its g-point window times its
    scaling row. Returns a new tensor."""
    ntemp, neta, ncont = kminor.shape
    kflat = kminor.reshape(ntemp * neta, ncont)
    jt = co.jtemp.long()
    ft = (1.0 - co.ftemp, co.ftemp)
    out = tau.clone()
    for m, (f, g0, w, s0) in enumerate(minors):
        win = kflat[:, s0:s0 + w]
        kk = None
        for it in (0, 1):
            row = (jt + it) * neta + co.jeta[it, f].long()
            fe = co.feta[it, f]
            lo = win[row].movedim(-1, 0)                 # (w, *S)
            hi = win[row + 1].movedim(-1, 0)
            t = ((1.0 - fe) * ft[it]) * lo + (fe * ft[it]) * hi
            kk = t if kk is None else kk + t
        out[g0:g0 + w] += scaling[m] * kk
    return out


def tau_rayleigh(co: InterpCoeffs, krayl, gpoint_flavor, rayscale):
    """Rayleigh optical depth (reference compute_tau_rayleigh, kernels
    :506-565): a 2-D lerp of krayl (ntemp, neta, ngpt, 2) in the cell's
    atmosphere, times ``rayscale`` = col_h2o + col_dry. (ngpt, *S)."""
    ntemp, neta, ngpt, _ = krayl.shape
    je, fe, _ = _weights(co, gpoint_flavor)
    g = torch.arange(ngpt, device=krayl.device).view(
        (-1,) + (1,) * co.jtemp.ndim)
    jt = co.jtemp.long()
    atm = torch.where(co.tropo, 0, 1)
    ft = (1.0 - co.ftemp, co.ftemp)
    kflat = krayl.reshape(-1)
    k = None
    for it in (0, 1):
        base = ((jt + it) * neta + je[it]) * ngpt + g
        lo = kflat[base * 2 + atm]
        hi = kflat[(base + ngpt) * 2 + atm]
        t = ((1.0 - fe[it]) * ft[it]) * lo + (fe[it] * ft[it]) * hi
        k = t if k is None else k + t
    return k * rayscale


def interp1d_table(val, offset, delta, table):
    """Linear interpolation returning every value along the table's second
    axis (reference interpolate1D, kernels :715-737): val (...), table
    (ntab, nout) -> (..., nout). The fraction comes from the unclipped
    position, so values off the table extrapolate."""
    ntab = table.shape[0]
    val0 = (val - offset) / delta
    frac = val0 - torch.trunc(val0)
    idx = torch.clamp(val0.to(torch.int32), 0, ntab - 2).long()
    lo = table[idx]
    hi = table[idx + 1]
    return lo + frac[..., None] * (hi - lo)


@trace.spanned("sources.planck")
def planck_sources(pfrac, *, totplnk, totplnk_delta, temp_ref_min, gpt2band,
                   tlay, tlev, tsfc, top_at_1: bool):
    """Planck sources in the public layout (reference
    compute_Planck_source, kernels :568-710): the totplnk lerp by
    temperature, band -> g-point, geometric-mean level sources, and the
    surface Jacobian by a 1 K difference. pfrac (ncol, nlay, ngpt);
    tlay (ncol, nlay), tlev (ncol, nlay+1), tsfc (ncol,). Returns
    (sfc_src, lay_src, lev_src, sfc_src_jac)."""
    if isinstance(gpt2band, torch.Tensor):
        band = gpt2band.to(pfrac.device).long()
    else:
        with trace.wait("planck.gpt2band"):
            band = torch.as_tensor(gpt2band, device=pfrac.device).long()
    pb = lambda t: interp1d_table(t, temp_ref_min, totplnk_delta,
                                  totplnk).index_select(-1, band)
    pf_sfc = pfrac[:, -1 if top_at_1 else 0, :]
    pb_sfc = pb(tsfc)
    sfc_src = pf_sfc * pb_sfc
    sfc_src_jac = pf_sfc * (pb(tsfc + 1.0) - pb_sfc)
    lay_src = pfrac * pb(tlay)
    lev_src = level_pfrac(pfrac) * pb(tlev)
    return sfc_src, lay_src, lev_src, sfc_src_jac


def level_pfrac(pfrac):
    """Planck fractions at the levels from those of the layers on axis 1
    (reference :695-706): the geometric mean of the two adjacent layers
    inside, 0 where their product is not positive; the top and bottom
    levels take their layer's value. (a, nlay, b) -> (a, nlay+1, b)."""
    pp = pfrac[:, 1:] * pfrac[:, :-1]
    pf_in = torch.where(pp > 0.0, torch.sqrt(torch.where(pp > 0.0, pp, 1.0)),
                        0.0)
    return torch.cat([pfrac[:, :1], pf_in, pfrac[:, -1:]], dim=1)


def planck_bands_lanes(t, *, totplnk, totplnk_delta, temp_ref_min):
    """Band Planck values by temperature with the band axis leading (the
    JAX ``planck_bands_lanes``, ops/gas_optics.py:410-421): t (...) ->
    (nbnd, ...), a permuted view of :func:`interp1d_table`'s result."""
    return interp1d_table(t, temp_ref_min, totplnk_delta,
                          totplnk).movedim(-1, 0)
