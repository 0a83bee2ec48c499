"""Longwave no-scattering solver and the adding method (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.ops.solver_lw`` (reference
rte/kernels/mo_rte_solver_kernels.F90): ``lw_source_noscat`` (:620-675),
the one-angle emission/absorption solve (:51-240) and Shonk-Hogan
``adding`` (:1135-1245). Fields use the lane layout (ngpt, nlay[+1],
ncol), top at index 0; the layer recurrences are Python loops over
(ngpt, ncol) slices.
"""
from __future__ import annotations

import math

import torch

__all__ = ["GAUSS_DS", "GAUSS_WTS", "lw_source_noscat", "lw_solver_noscat",
           "adding"]

# one-angle Gauss-Jacobi-5 secant and weight (Hogan 2023 Table 1; reference
# mo_rte_lw.F90:135-160)
GAUSS_DS = 1.0 / 0.6096748751
GAUSS_WTS = 1.0


def lw_source_noscat(lay_source, lev_top, lev_bot, tau, trans):
    """Linear-in-tau layer emission toward each face (Clough et al. 1992
    Eq 13, with the small-tau series of :652-655). Returns (source_dn,
    source_up): "dn" exits the layer bottom, "up" its top."""
    finfo = torch.finfo(tau.dtype)
    tau_thresh = math.sqrt(math.sqrt(finfo.eps))
    fact_big = (1.0 - trans) / torch.clamp(tau, min=finfo.tiny) - trans
    fact_small = tau * (0.5 + tau * (-1.0 / 3.0 + tau * (1.0 / 8.0)))
    fact = torch.where(tau > tau_thresh, fact_big, fact_small)
    source_dn = (1.0 - trans) * lev_bot + 2.0 * fact * (lay_source - lev_bot)
    source_up = (1.0 - trans) * lev_top + 2.0 * fact * (lay_source - lev_top)
    return source_dn, source_up


def lw_solver_noscat(tau, lay_source, lev_source, sfc_emis, sfc_src, *,
                     ds: float = GAUSS_DS, weight: float = GAUSS_WTS):
    """One-angle no-scattering solve with zero incident flux (reference
    lw_solver_noscat_oneangle): tau/lay_source (ngpt, nlay, ncol),
    lev_source (ngpt, nlay+1, ncol), sfc_emis/sfc_src (ngpt, ncol).
    Returns broadband (flux_up, flux_dn), each (nlay+1, ncol) in W/m2."""
    nlay = tau.shape[1]
    tau_loc = tau * ds
    trans = torch.exp(-tau_loc)
    sdn, sup = lw_source_noscat(lay_source, lev_source[:, :-1],
                                lev_source[:, 1:], tau_loc, trans)
    radn_dn = [torch.zeros_like(sfc_src)]
    for l in range(nlay):
        radn_dn.append(trans[:, l] * radn_dn[-1] + sdn[:, l])
    radn_up = [radn_dn[-1] * (1.0 - sfc_emis) + sfc_emis * sfc_src]
    for l in range(nlay - 1, -1, -1):
        radn_up.append(trans[:, l] * radn_up[-1] + sup[:, l])
    radn_up.reverse()
    piw = math.pi * weight
    up = torch.stack(radn_up, dim=1).sum(0) * piw
    dn = torch.stack(radn_dn, dim=1).sum(0) * piw
    return up, dn


def adding(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc, flux_dn_top):
    """Shonk & Hogan 2008 adding for diffuse transport (Eqs 9-13), top at
    index 0. rdif/tdif/src_* (ngpt, nlay, ncol); albedo_sfc/src_sfc/
    flux_dn_top (ngpt, ncol). Returns (flux_up, flux_dn), each
    (ngpt, nlay+1, ncol)."""
    nlay = rdif.shape[1]
    albedo = [None] * (nlay + 1)
    src = [None] * (nlay + 1)
    denom = [None] * nlay
    albedo[nlay], src[nlay] = albedo_sfc, src_sfc
    for v in range(nlay - 1, -1, -1):
        r, t = rdif[:, v], tdif[:, v]
        denom[v] = 1.0 / (1.0 - r * albedo[v + 1])                     # Eq 10
        albedo[v] = r + t * t * albedo[v + 1] * denom[v]                # Eq 9
        src[v] = src_up[:, v] + t * denom[v] * (
            src[v + 1] + albedo[v + 1] * src_dn[:, v])                  # Eq 11
    fdn = [flux_dn_top]
    fup = [flux_dn_top * albedo[0] + src[0]]                            # Eq 12
    for v in range(nlay):
        f = (tdif[:, v] * fdn[-1] + rdif[:, v] * src[v + 1]
             + src_dn[:, v]) * denom[v]                                 # Eq 13
        fdn.append(f)
        fup.append(f * albedo[v + 1] + src[v + 1])
    return torch.stack(fup, dim=1), torch.stack(fdn, dim=1)
