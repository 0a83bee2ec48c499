"""RRTMGP correlated-k gas-optics numerics on tensors (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.ops.gas_optics`` (reference kernels
rrtmgp/kernels/mo_gas_optics_rrtmgp_kernels.F90): ``interpolation``
(:37-170), the major/minor absorption (:345-501), Rayleigh (:506-565) and
the Planck source (:568-710). These are the building blocks of the fused
kernels' plain twins.

Conventions: cell arrays have any shape ``S`` (the drivers use layer-major
``(nlay, ncol)``); spectral outputs are ``(ngpt, *S)``, g-points leading.
Tables are the KDist's plain layouts; indices are 0-based.
  col_gas  (ngas+1, *S), dry air at index 0
  jeta, col_mix, feta  (2, nflav, *S), axis 0 = temperature corner
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["InterpCoeffs", "interpolation", "tau_major", "tau_minor",
           "minor_scaling", "tau_rayleigh", "planck_bands", "planck_sources"]


class InterpCoeffs(NamedTuple):
    jtemp: torch.Tensor     # (*S) int32, lower temperature index
    ftemp: torch.Tensor     # (*S)
    jpress: torch.Tensor    # (*S) int32, lower pressure index
    fpress: torch.Tensor    # (*S)
    tropo: torch.Tensor     # (*S) bool, True = lower atmosphere
    jeta: torch.Tensor      # (2, nflav, *S) int32
    col_mix: torch.Tensor   # (2, nflav, *S)
    feta: torch.Tensor      # (2, nflav, *S)


def interpolation(play, tlay, col_gas, *, flavor, neta: int, press_ref_log,
                  temp_ref, press_ref_log_delta, temp_ref_min,
                  temp_ref_delta, press_ref_trop_log,
                  vmr_ref) -> InterpCoeffs:
    """Temperature/pressure/eta interpolation coefficients (reference
    ``rrtmgp_interpolation``, kernels :37-170). Each index and its
    fraction derive from ONE computed value (eager PyTorch materializes
    it once), so an index never pairs with the other side's fraction."""
    dtype = play.dtype
    dev = play.device
    ntemp = temp_ref.shape[0]
    npres = press_ref_log.shape[0]

    # temperature (reference :106-108); ftemp anchors at the CLAMPED node
    loctemp = (tlay - (temp_ref_min - temp_ref_delta)) / temp_ref_delta
    jtemp1 = torch.clamp(torch.floor(loctemp).to(torch.int32), 1, ntemp - 1)
    temp_ref_t = torch.as_tensor(temp_ref, dtype=dtype, device=dev)
    ftemp = (tlay - temp_ref_t[jtemp1.long() - 1]) / temp_ref_delta
    jtemp = jtemp1 - 1

    # pressure (reference :111-114)
    locpress = 1.0 + (torch.log(play) - float(press_ref_log[0])) \
        / press_ref_log_delta
    jpress_f = torch.clamp(torch.trunc(locpress), 1.0, float(npres - 1))
    fpress = locpress - jpress_f
    jpress = jpress_f.to(torch.int32) - 1

    tropo = play > torch.exp(torch.tensor(press_ref_trop_log, dtype=dtype))

    # eta per flavor and reference temperature (reference :121-168)
    g1, g2 = np.asarray(flavor[0]), np.asarray(flavor[1])
    vmr_ref = np.asarray(vmr_ref)
    ratio = torch.as_tensor(vmr_ref[:, g1, :] / vmr_ref[:, g2, :],
                            dtype=dtype, device=dev)     # (2, nflav, ntemp)
    tiny = torch.finfo(dtype).tiny
    cg1 = col_gas[torch.as_tensor(g1, device=dev)]       # (nflav, *S)
    cg2 = col_gas[torch.as_tensor(g2, device=dev)]
    cms, jes, fes = [], [], []
    for it in (0, 1):
        jt_i = torch.clamp(jtemp + it, 0, ntemp - 1).long()
        r = torch.where(tropo, ratio[0][:, jt_i], ratio[1][:, jt_i])
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


def minor_scaling(co: InterpCoeffs, mset, *, lower: bool, play, tlay,
                  col_gas, idx_h2o: int):
    """Per-minor-gas scaling rows with the atmosphere mask applied
    (reference gas_optical_depths_minor :461-480): (nminor, *S)."""
    dtype = play.dtype
    maskf = (co.tropo if lower else ~co.tropo).to(dtype)
    inv_col_dry = 1.0 / col_gas[0]
    dry_fact = 1.0 / (1.0 + col_gas[idx_h2o] * inv_col_dry)
    rows = []
    for m in range(len(mset.kminor_start)):
        scaling = col_gas[int(mset.idx_minor[m])]
        if mset.scales_with_density[m]:
            scaling = scaling * (0.01 * play / tlay)
            isc = int(mset.idx_minor_scaling[m])
            if isc > 0:
                frac = col_gas[isc] * inv_col_dry * dry_fact
                scaling = scaling * ((1.0 - frac)
                                     if mset.scale_by_complement[m] else frac)
        rows.append(scaling * maskf)
    if not rows:
        return play.new_zeros((0,) + tuple(play.shape))
    return torch.stack(rows)


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


def planck_bands(t, totplnk, *, tp_min: float, tp_delta: float):
    """Band-integrated Planck function by temperature (reference
    interpolate1D, kernels :715-737): t (*S) -> (nbnd, *S)."""
    ntab = totplnk.shape[0]
    val0 = (t - tp_min) / tp_delta
    frac = val0 - torch.trunc(val0)
    idx = torch.clamp(val0.to(torch.int32), 0, ntab - 2).long()
    lo = totplnk[idx].movedim(-1, 0)
    hi = totplnk[idx + 1].movedim(-1, 0)
    return lo + frac * (hi - lo)


def planck_sources(pfrac, gpt2band, pb_lay, pb_lev, pb_sfc):
    """Planck sources on the layer-major lane layout (reference
    compute_Planck_source :568-710): pfrac (ngpt, nlay, ncol); pb_* band
    Planck values (nbnd, nlay[+1], ncol) and (nbnd, ncol). Level sources
    use the geometric mean of the adjacent layers' pfrac inside and the
    adjacent layer's pfrac at the ends. Returns (lay (ngpt, nlay, ncol),
    lev (ngpt, nlay+1, ncol), sfc (ngpt, ncol)), top at index 0."""
    band = torch.as_tensor(gpt2band, device=pfrac.device).long()
    lay = pfrac * pb_lay[band]
    pp = pfrac[:, 1:] * pfrac[:, :-1]
    pf_in = torch.where(pp > 0.0, torch.sqrt(torch.where(pp > 0.0, pp, 1.0)),
                        0.0)
    pf_lev = torch.cat([pfrac[:, :1], pf_in, pfrac[:, -1:]], dim=1)
    lev = pf_lev * pb_lev[band]
    sfc = pfrac[:, -1] * pb_sfc[band]
    return lay, lev, sfc
