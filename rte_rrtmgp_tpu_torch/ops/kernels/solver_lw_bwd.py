"""Adjoint of the one-angle LW no-scattering solve with broadband output:
the CUDA kernel ``csrc/solver_lw_bwd.cu``, its plain twin, and
:func:`lw_noscat_vjp`, the solve whose backward is that kernel.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/solver_lw_bwd.py::
_lw_bwd_lane`` (and its ``lw_noscat_broadband_lane_vjp``): for a scalar
secant, no rescaling and no Jacobian (the dispatch rule of the JAX
package's ``ops/solver_lw.py:338-350``), the cotangents of tau, the layer
and level sources, the surface emissivity and source and the incident
flux from those of the broadband up and down fluxes. The plain twin is
``torch.autograd.grad`` of ``lw_noscat_plain``.
"""
from __future__ import annotations

import torch

from ...constants import PI
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad, with_adjoint
from .solver_lw import lw_noscat, lw_noscat_plain

__all__ = ["lw_noscat_vjp", "lw_noscat_bwd", "lw_noscat_bwd_plain",
           "lw_noscat_bwd_occupancy"]


def lw_noscat_bwd_occupancy(ngpt: int) -> int:
    """Resident blocks per SM of the adjoint kernel for ngpt g-points
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); it needs no
    scratch."""
    return query("solver_lw_bwd", "occupancy_solver_lw_bwd", ngpt)


def lw_noscat_bwd_plain(tau, lay, lev, sfc_emis, sfc_src, inc_flux, g_up,
                        g_dn, *, ds: float, weight: float):
    """Cotangents (tau, lay, lev, sfc_emis, sfc_src, inc_flux) of
    ``lw_noscat_plain`` (broadband, scalar secant) for the cotangents g_up,
    g_dn (ncol, nlay+1) of its fluxes."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in
              (tau, lay, lev, sfc_emis, sfc_src, inc_flux)]
        up, dn, _ = lw_noscat_plain(*xs, ds=ds, weight=weight)
        return torch.autograd.grad((up, dn), xs, (g_up, g_dn))


def lw_noscat_bwd(tau, lay, lev, sfc_emis, sfc_src, inc_flux, g_up, g_dn, *,
                  ds: float, weight: float):
    """:func:`lw_noscat_bwd_plain` semantics; on CUDA, one launch of the
    hand-written adjoint kernel (counted in ``lw_noscat_bwd.launches``)."""
    if on_cpu(tau, "lw_noscat_bwd"):
        return lw_noscat_bwd_plain(tau, lay, lev, sfc_emis, sfc_src,
                                   inc_flux, g_up, g_dn, ds=ds, weight=weight)
    refuse_grad("lw_noscat_bwd", tau, lay, lev, sfc_emis, sfc_src, inc_flux,
                g_up, g_dn, hint="the adjoints have no backward of their own")
    ncol, nlay, ngpt = tau.shape
    if ngpt > 1024:
        raise ValueError(f"lw_noscat_bwd: {ngpt} g-points exceed one CUDA "
                         "block")
    f32 = torch.float32
    lay3, bc, lev2 = (ncol, nlay, ngpt), (ncol, ngpt), (ncol, nlay + 1)
    g_up, g_dn = g_up.contiguous(), g_dn.contiguous()
    dev = tau.device
    check_args("lw_noscat_bwd", dev, {
        "tau": (tau, lay3, f32), "lay": (lay, lay3, f32),
        "lev": (lev, (ncol, nlay + 1, ngpt), f32),
        "sfc_emis": (sfc_emis, bc, f32), "sfc_src": (sfc_src, bc, f32),
        "inc_flux": (inc_flux, bc, f32), "g_up": (g_up, lev2, f32),
        "g_dn": (g_dn, lev2, f32)})
    outs = (torch.empty_like(tau), torch.empty_like(tau),
            torch.empty_like(lev), torch.empty_like(sfc_emis),
            torch.empty_like(sfc_emis), torch.empty_like(sfc_emis))
    launch("solver_lw_bwd", "launch_solver_lw_bwd", "lw_noscat_bwd",
           tau, lay, lev, sfc_emis, sfc_src, inc_flux, g_up, g_dn, *outs,
           ncol, nlay, ngpt, float(ds), PI * float(weight))
    lw_noscat_bwd.launches += 1
    return outs


lw_noscat_bwd.launches = 0


def lw_noscat_vjp(tau, lay, lev, sfc_emis, sfc_src, inc_flux, *, ds: float,
                  weight: float):
    """Broadband (flux_up, flux_dn) of ``lw_noscat`` as one autograd node
    whose backward is :func:`lw_noscat_bwd` (the adjoint kernel on CUDA,
    the twin's gradient on the CPU). Inputs as ``lw_noscat``, contiguous,
    with a scalar secant and no rescaling or Jacobian."""
    ds, weight = float(ds), float(weight)
    return with_adjoint(
        lambda *a: lw_noscat(*a, ds=ds, weight=weight)[:2],
        lambda *a: lw_noscat_plain(*a, ds=ds, weight=weight)[:2],
        lambda a, g_up, g_dn: lw_noscat_bwd(*a, g_up, g_dn, ds=ds,
                                            weight=weight),
        tau, lay, lev, sfc_emis, sfc_src, inc_flux)
