"""Shortwave two-stream solver (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.ops.solver_sw`` (reference
rte/kernels/mo_rte_solver_kernels.F90): ``sw_dif_and_source``
(:985-1127: Zdunkowski PIFM gammas, Meador-Weaver Eqs 14/15/25/26, the
Hogan/Ukkonen energy clamps, night masking) and ``sw_solver_2stream``
(:503-609, with the adding method of ``solver_lw.adding``). Fields use the
lane layout (ngpt, nlay[+1], ncol), top at index 0.
"""
from __future__ import annotations

import math

import torch

from .solver_lw import adding

__all__ = ["sw_dif_and_source", "sw_solver_2stream"]


def sw_dif_and_source(tau, w0, g, mu0, inc_flux_dir, sfc_alb_dir):
    """Layer diffuse R/T and direct-beam-driven sources. tau/w0/g
    (ngpt, nlay, ncol); mu0 (nlay, ncol); inc_flux_dir/sfc_alb_dir
    (ngpt, ncol). Returns (rdif, tdif, source_dn, source_up, source_sfc,
    flux_dir), flux_dir at levels (ngpt, nlay+1, ncol)."""
    eps = torch.finfo(tau.dtype).eps
    min_k = 1.0e4 * eps
    min_mu0 = math.sqrt(eps)
    gamma1 = (8.0 - w0 * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (w0 * (1.0 - g)) * 0.25
    k = torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2),
                               min=min_k))
    e1 = torch.exp(-tau * k)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt * gamma2 * (1.0 - e2)          # MW Eq 25
    tdif = rt * 2.0 * k * e1                 # MW Eq 26

    mu0_s = torch.clamp(mu0, min=min_mu0)
    k_mu = k * mu0_s
    denom = 1.0 - k_mu * k_mu
    denom = torch.where(torch.abs(denom) >= eps, denom, eps)
    rt2 = w0 * rt / denom
    gamma3 = (2.0 - 3.0 * mu0_s * g) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k_g3 = k * gamma3
    k_g4 = k * gamma4
    tnoscat = torch.exp(-tau / mu0_s)
    rdir = rt2 * ((1.0 - k_mu) * (alpha2 + k_g3)
                  - (1.0 + k_mu) * (alpha2 - k_g3) * e2
                  - 2.0 * (k_g3 - alpha2 * k_mu) * e1 * tnoscat)
    tdir = -rt2 * ((1.0 + k_mu) * (alpha1 + k_g4) * tnoscat
                   - (1.0 - k_mu) * (alpha1 - k_g4) * e2 * tnoscat
                   - 2.0 * (k_g4 + alpha1 * k_mu) * e1)
    # energy-safety clamps (reference :1103-1108)
    rdir = torch.minimum(torch.clamp(rdir, min=0.0), 1.0 - tnoscat)
    tdir = torch.minimum(torch.clamp(tdir, min=0.0), 1.0 - tnoscat - rdir)

    # direct beam at levels: cumulative transmission
    seed = inc_flux_dir * mu0[0]                         # (ngpt, ncol)
    flux_dir = seed[:, None] * torch.cat(
        [torch.ones_like(tnoscat[:, :1]), torch.cumprod(tnoscat, dim=1)],
        dim=1)
    dir_inc = flux_dir[:, :-1]
    day = mu0 > 0.0
    source_up = torch.where(day, rdir * dir_inc, 0.0)
    source_dn = torch.where(day, tdir * dir_inc, 0.0)
    source_sfc = torch.where(mu0[-1] > 0.0, flux_dir[:, -1] * sfc_alb_dir,
                             0.0)
    return rdif, tdif, source_dn, source_up, source_sfc, flux_dir


def sw_solver_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir):
    """Two-stream SW solve with zero diffuse incident flux. Returns
    broadband (flux_up, flux_dn total = diffuse + direct, flux_dir),
    each (nlay+1, ncol)."""
    rdif, tdif, src_dn, src_up, src_sfc, flux_dir = sw_dif_and_source(
        tau, ssa, g, mu0, inc_flux_dir, sfc_alb_dir)
    flux_up, flux_dn = adding(sfc_alb_dif, rdif, tdif, src_dn, src_up,
                              src_sfc, torch.zeros_like(inc_flux_dir))
    flux_dn = flux_dn + flux_dir
    return flux_up.sum(0), flux_dn.sum(0), flux_dir.sum(0)
