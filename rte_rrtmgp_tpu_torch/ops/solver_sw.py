"""Shortwave solvers (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.ops.solver_sw`` (reference
rte/kernels/mo_rte_solver_kernels.F90): ``sw_solver_noscat`` (:450-494,
the direct beam), ``sw_dif_and_source`` (:985-1127: Zdunkowski PIFM
gammas, Meador-Weaver Eqs 14/15/25/26, the Hogan/Ukkonen energy clamps,
night masking) and ``sw_solver_2stream`` (:503-609, with the adding method
of ``solver_lw.adding``).

Public fields are (ncol, nlay[+1], ngpt), mu0 (ncol, nlay). The
broadband and by-band two-stream solves are the hand-written kernel
``ops/kernels/solver_sw`` on a CUDA tensor.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .solver_lw import adding

__all__ = ["SWFluxes", "sw_solver_noscat", "sw_dif_and_source",
           "two_stream", "sw_solver_2stream"]


class SWFluxes(NamedTuple):
    flux_up: torch.Tensor   # (ncol, nlev), (ncol, nlev, nband) or ngpt
    flux_dn: torch.Tensor   # total down (diffuse + direct)
    flux_dir: torch.Tensor  # direct beam down


def sw_solver_noscat(tau, mu0, inc_flux_dir, *, top_at_1: bool):
    """Direct beam only (reference rte_sw_solver_noscat): tau (ncol, nlay,
    ngpt), mu0 (ncol, nlay), inc_flux_dir (ncol, ngpt). Night layers
    (mu0 <= 0) carry no beam. Returns flux_dir (ncol, nlay+1, ngpt)."""
    if not top_at_1:
        tau, mu0 = torch.flip(tau, [1]), torch.flip(mu0, [1])
    day = mu0 > 0.0
    mu0_safe = torch.where(day, mu0, 1.0)
    trans = torch.where(day[:, :, None], torch.exp(-tau / mu0_safe[:, :, None]),
                        0.0)
    seed = (inc_flux_dir * torch.where(day[:, :1], mu0[:, :1], 0.0))[:, None]
    flux_dir = seed * torch.cat([torch.ones_like(seed),
                                 torch.cumprod(trans, dim=1)], dim=1)
    return flux_dir if top_at_1 else torch.flip(flux_dir, [1])


def sw_dif_and_source(tau, w0, g, mu0, inc_flux_dir, sfc_alb_dir):
    """Layer diffuse R/T and direct-beam-driven sources, top at index 0.
    tau/w0/g (ncol, nlay, ngpt); mu0 (ncol, nlay); inc_flux_dir/
    sfc_alb_dir (ncol, ngpt). Returns (rdif, tdif, source_dn, source_up,
    source_sfc, flux_dir), flux_dir at levels (ncol, nlay+1, ngpt)."""
    mu0e = mu0[:, :, None]
    eps = torch.finfo(tau.dtype).eps
    min_k = 1.0e4 * eps
    min_mu0 = math.sqrt(eps)
    gamma1 = (8.0 - w0 * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (w0 * (1.0 - g)) * 0.25
    # maximum/minimum rather than clamp: at a tie the gradient splits
    # half and half, as jnp.maximum's and jnp.clip's do in the JAX package
    lo = lambda x, c: torch.maximum(x, x.new_tensor(c))
    k = torch.sqrt(lo((gamma1 - gamma2) * (gamma1 + gamma2), min_k))
    e1 = torch.exp(-tau * k)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt * gamma2 * (1.0 - e2)          # MW Eq 25
    tdif = rt * 2.0 * k * e1                 # MW Eq 26

    mu0_s = lo(mu0e, min_mu0)
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
    rdir = torch.minimum(lo(rdir, 0.0), 1.0 - tnoscat)
    tdir = torch.minimum(lo(tdir, 0.0), 1.0 - tnoscat - rdir)

    # direct beam at levels: cumulative transmission
    seed = (inc_flux_dir * mu0[:, :1])[:, None]
    flux_dir = seed * torch.cat([torch.ones_like(seed),
                                 torch.cumprod(tnoscat, dim=1)], dim=1)
    dir_inc = flux_dir[:, :-1]
    day = mu0e > 0.0
    source_up = torch.where(day, rdir * dir_inc, 0.0)
    source_dn = torch.where(day, tdir * dir_inc, 0.0)
    source_sfc = torch.where(mu0[:, -1:] > 0.0, flux_dir[:, -1] * sfc_alb_dir,
                             0.0)
    return rdif, tdif, source_dn, source_up, source_sfc, flux_dir


def two_stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
               inc_flux_dif=None, *, spectral=False):
    """Two-stream + adding, top at index 0: broadband (ncol, nlev) fluxes
    (flux_up, flux_dn total = diffuse + direct, flux_dir), or per g-point
    with ``spectral``."""
    rdif, tdif, src_dn, src_up, src_sfc, flux_dir = sw_dif_and_source(
        tau, ssa, g, mu0, inc_flux_dir, sfc_alb_dir)
    top = (torch.zeros_like(inc_flux_dir) if inc_flux_dif is None
           else inc_flux_dif)
    flux_up, flux_dn = adding(sfc_alb_dif, rdif, tdif, src_dn, src_up,
                              src_sfc, top)
    flux_dn = flux_dn + flux_dir             # total = diffuse + direct (:606)
    if spectral:
        return flux_up, flux_dn, flux_dir
    return flux_up.sum(-1), flux_dn.sum(-1), flux_dir.sum(-1)


def sw_solver_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                      inc_flux_dir, *, top_at_1: bool, inc_flux_dif=None,
                      spectral: bool = False, gpt2band=None,
                      nband: int = 0) -> SWFluxes:
    """Two-stream SW solve (reference rte_sw_solver_2stream, :503-609).
    tau/ssa/g (ncol, nlay, ngpt); mu0 (ncol, nlay), per layer for
    spherical geometry; boundary fields (ncol, ngpt). Broadband output,
    or per-band sums (ncol, nlay+1, nband) with ``gpt2band`` (int32,
    0-based band of each g-point) and ``nband``, goes through
    ``ops/kernels/solver_sw`` (the CUDA kernel on a CUDA tensor, its twin
    on a CPU one); ``spectral`` output is plain code. Differentiable: the
    broadband solve's backward is the adjoint kernel
    (``solver_sw_bwd.sw_2stream_vjp``, JAX ops/solver_sw.py:196-208), the
    by-band solve's the twin's gradient (the JAX rule: its adjoint kernel
    is broadband only)."""
    from .kernels.autodiff import with_twin_grad
    from .kernels.solver_sw import sw_2stream, sw_2stream_plain
    from .kernels.solver_sw_bwd import sw_2stream_vjp

    if not top_at_1:
        tau, ssa, g = (torch.flip(x, [1]) for x in (tau, ssa, g))
        mu0 = torch.flip(mu0, [1])
    if spectral:
        up, dn, fdir = two_stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                                  inc_flux_dir, inc_flux_dif, spectral=True)
    else:
        c = lambda x: None if x is None else x.contiguous()
        args = tuple(c(x) for x in (tau, ssa, g, mu0, sfc_alb_dir,
                                    sfc_alb_dif, inc_flux_dir, inc_flux_dif))
        if gpt2band is None:
            up, dn, fdir = sw_2stream_vjp(*args)
        else:
            up, dn, fdir = with_twin_grad(
                lambda *a: sw_2stream(*a, nband=nband),
                lambda *a: sw_2stream_plain(*a, nband=nband), *args,
                gpt2band, name="sw_2stream")
    if not top_at_1:
        up, dn, fdir = (torch.flip(x, [1]) for x in (up, dn, fdir))
    return SWFluxes(flux_up=up, flux_dn=dn, flux_dir=fdir)
