"""Adjoint of the SW two-stream solve with broadband output: the CUDA
kernel ``csrc/solver_sw_bwd.cu``, its plain twin, and
:func:`sw_2stream_vjp`, the solve whose backward is that kernel.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/solver_sw_bwd.py::
_sw_bwd_lane`` (and its ``sw_two_stream_broadband_lane_vjp``): the
cotangents of tau, ssa, g, mu0, both albedos and both incident fluxes
from those of the broadband up, total down and direct fluxes, the
diffuse incident flux zero when absent (JAX ``ops/solver_sw.py:196-208``).
The plain twin is ``torch.autograd.grad`` of ``sw_2stream_plain``. The
kernel keeps a column's state in shared memory
(:func:`sw_2stream_bwd_geometry`), so on CUDA the column height is bounded
and a taller one raises ValueError naming the limit; the twin has no
limit.
"""
from __future__ import annotations

import torch

from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad, with_adjoint
from .onchip import Geometry, onchip_geometry
from .solver_sw import sw_2stream, sw_2stream_plain

__all__ = ["sw_2stream_vjp", "sw_2stream_bwd", "sw_2stream_bwd_plain",
           "sw_2stream_bwd_geometry", "sw_2stream_bwd_scratch_bytes",
           "sw_2stream_bwd_occupancy"]


def sw_2stream_bwd_geometry(nlay: int, ngpt: int) -> Geometry:
    """Chunk width, cluster size, threads and shared memory per block of
    the adjoint kernel at nlay layers and ngpt g-points
    (:func:`onchip.onchip_geometry`); raises ValueError where a column's
    state does not fit on chip."""
    return onchip_geometry("solver_sw_bwd", nlay, ngpt)


def sw_2stream_bwd_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one :func:`sw_2stream_bwd` launch: none, the
    state stays in shared memory."""
    return 0


def sw_2stream_bwd_occupancy(nlay: int, ngpt: int) -> tuple:
    """(resident blocks per SM, clusters the card holds at once) of the
    adjoint kernel at these sizes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor and
    cudaOccupancyMaxActiveClusters."""
    geo = sw_2stream_bwd_geometry(nlay, ngpt)
    n = query("solver_sw_bwd", "occupancy_solver_sw_bwd", nlay, geo.chunk,
              geo.nchunk)
    return (n // 65536, n % 65536) if n >= 0 else (n, n)


def sw_2stream_bwd_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                         inc_flux_dir, inc_flux_dif, g_up, g_dn, g_dir):
    """Cotangents (tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
    inc_flux_dir, inc_flux_dif) of ``sw_2stream_plain`` for the cotangents
    g_up, g_dn, g_dir (ncol, nlay+1) of its fluxes."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in
              (tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
               inc_flux_dif)]
        out = sw_2stream_plain(*xs)
        return torch.autograd.grad(out, xs, (g_up, g_dn, g_dir))


def sw_2stream_bwd(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                   inc_flux_dif, g_up, g_dn, g_dir):
    """:func:`sw_2stream_bwd_plain` semantics; on CUDA, one launch of the
    hand-written adjoint kernel (counted in ``sw_2stream_bwd.launches``)."""
    if on_cpu(tau, "sw_2stream_bwd"):
        return sw_2stream_bwd_plain(tau, ssa, g, mu0, sfc_alb_dir,
                                    sfc_alb_dif, inc_flux_dir, inc_flux_dif,
                                    g_up, g_dn, g_dir)
    refuse_grad("sw_2stream_bwd", tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                inc_flux_dir, inc_flux_dif, g_up, g_dn, g_dir,
                hint="the adjoints have no backward of their own")
    ncol, nlay, ngpt = tau.shape
    f32 = torch.float32
    lay3, bc, lev2 = (ncol, nlay, ngpt), (ncol, ngpt), (ncol, nlay + 1)
    g_up, g_dn, g_dir = (x.contiguous() for x in (g_up, g_dn, g_dir))
    dev = tau.device
    check_args("sw_2stream_bwd", dev, {
        "tau": (tau, lay3, f32), "ssa": (ssa, lay3, f32),
        "g": (g, lay3, f32), "mu0": (mu0, (ncol, nlay), f32),
        "sfc_alb_dir": (sfc_alb_dir, bc, f32),
        "sfc_alb_dif": (sfc_alb_dif, bc, f32),
        "inc_flux_dir": (inc_flux_dir, bc, f32),
        "inc_flux_dif": (inc_flux_dif, bc, f32), "g_up": (g_up, lev2, f32),
        "g_dn": (g_dn, lev2, f32), "g_dir": (g_dir, lev2, f32)})
    geo = sw_2stream_bwd_geometry(nlay, ngpt)
    outs = (torch.empty_like(tau), torch.empty_like(tau),
            torch.empty_like(tau), torch.empty_like(mu0),
            *(torch.empty_like(inc_flux_dir) for _ in range(4)))
    launch("solver_sw_bwd", "launch_solver_sw_bwd", "sw_2stream_bwd",
           tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
           inc_flux_dif, g_up, g_dn, g_dir, *outs, ncol, nlay, ngpt,
           geo.chunk)
    sw_2stream_bwd.launches += 1
    return outs


sw_2stream_bwd.launches = 0


def sw_2stream_vjp(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                   inc_flux_dif=None):
    """Broadband (flux_up, flux_dn total, flux_dir) of ``sw_2stream`` as
    one autograd node whose backward is :func:`sw_2stream_bwd` (the adjoint
    kernel on CUDA, the twin's gradient on the CPU). Inputs as
    ``sw_2stream``, contiguous; a missing diffuse incident flux is zero."""
    if inc_flux_dif is None:
        inc_flux_dif = torch.zeros_like(inc_flux_dir)
    return with_adjoint(sw_2stream, sw_2stream_plain,
                        lambda a, *grads: sw_2stream_bwd(*a, *grads),
                        tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                        inc_flux_dir, inc_flux_dif)
