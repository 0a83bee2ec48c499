"""LW true two-stream solve with broadband or per-band output: the CUDA
kernel ``csrc/solver_lw_2str.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py::
lw_two_stream_broadband_lane`` (semantics of ``ops/solver_lw.py``'s
``lw_solver_2stream``, reference mo_rte_solver_kernels.F90:377-440): per
(column, g-point) the Meador-Weaver Rdif/Tdif with the LW diffusivity
secant 1.66, the Toon linear-in-B sources times pi, Shonk-Hogan adding
from the surface albedo 1 - emis and the incident flux, and the broadband
sums, or with ``gpt2band`` the per-band sums. The TPU kernel sums bands
only when they are uniform and their width divides 128; here any band of
each g-point works. The layer source is in the signature, as in the TPU
kernel, and is never read: the linear-in-B sources use the levels'.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`lw_2stream_plain`. The kernel has no backward, as
the TPU kernel has none: on CUDA it refuses inputs that require grad, and
``ops/solver_lw.lw_solver_2stream`` differentiates it through the twin.
"""
from __future__ import annotations

import torch

from ...fluxes import sum_bands
from ..solver_lw import two_stream_lw
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad
from .onchip import Geometry, onchip_geometry

__all__ = ["lw_2stream", "lw_2stream_plain", "lw_2stream_geometry",
           "lw_2stream_scratch_bytes", "lw_2stream_occupancy"]


def lw_2stream_plain(tau, ssa, g, lay_source, lev_source, sfc_emis, sfc_src,
                     inc_flux, gpt2band=None, *, nband: int = 0):
    """tau/ssa/g/lay_source (ncol, nlay, ngpt), top at layer 0;
    lev_source (ncol, nlay+1, ngpt); sfc_emis/sfc_src/inc_flux (ncol,
    ngpt). Returns (flux_up, flux_dn) in W/m2: broadband, each (ncol,
    nlay+1), or with ``gpt2band`` (ngpt,) the per-band sums (ncol, nlay+1,
    nband)."""
    up, dn = two_stream_lw(tau, ssa, g, lev_source, sfc_emis, sfc_src,
                           inc_flux)
    if gpt2band is None:
        return up.sum(-1), dn.sum(-1)
    return sum_bands(up, gpt2band, nband), sum_bands(dn, gpt2band, nband)


def lw_2stream_geometry(nlay: int, ngpt: int, nband: int = 0) -> Geometry:
    """Chunk width, cluster size, threads and shared memory per block of
    the kernel at nlay layers, ngpt g-points and nband bands (0:
    broadband) (:func:`onchip.onchip_geometry`); raises ValueError where
    a column's layer fields do not fit on chip."""
    return onchip_geometry("lw_2stream", nlay, ngpt, nband)


def lw_2stream_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one launch: none, the layer fields stay in shared
    memory."""
    return 0


def lw_2stream_occupancy(nlay: int, ngpt: int, nband: int = 0) -> tuple:
    """(resident blocks per SM, clusters the card holds at once) of the
    kernel at these sizes, from cudaOccupancyMaxActiveBlocksPer
    Multiprocessor and cudaOccupancyMaxActiveClusters."""
    geo = lw_2stream_geometry(nlay, ngpt, nband)
    n = query("solver_lw_2str", "occupancy_solver_lw_2str", nlay, geo.chunk,
              geo.nchunk, nband)
    return (n // 65536, n % 65536) if n >= 0 else (n, n)


def lw_2stream(tau, ssa, g, lay_source, lev_source, sfc_emis, sfc_src,
               inc_flux, gpt2band=None, *, nband: int = 0):
    """:func:`lw_2stream_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``lw_2stream.launches``)."""
    if on_cpu(tau, "lw_2stream"):
        return lw_2stream_plain(tau, ssa, g, lay_source, lev_source, sfc_emis,
                                sfc_src, inc_flux, gpt2band, nband=nband)
    refuse_grad("lw_2stream", tau, ssa, g, lay_source, lev_source, sfc_emis,
                sfc_src, inc_flux, hint="ops/solver_lw.lw_solver_2stream "
                "differentiates it (the twin's gradient)")
    ncol, nlay, ngpt = tau.shape
    f32 = torch.float32
    lay3, bc = (ncol, nlay, ngpt), (ncol, ngpt)
    specs = {"tau": (tau, lay3, f32), "ssa": (ssa, lay3, f32),
             "g": (g, lay3, f32), "lay_source": (lay_source, lay3, f32),
             "lev_source": (lev_source, (ncol, nlay + 1, ngpt), f32),
             "sfc_emis": (sfc_emis, bc, f32), "sfc_src": (sfc_src, bc, f32),
             "inc_flux": (inc_flux, bc, f32)}
    byband = gpt2band is not None
    if byband:
        if nband < 1:
            raise ValueError("lw_2stream: by-band output needs nband >= 1")
        specs["gpt2band"] = (gpt2band, (ngpt,), torch.int32)
    dev = tau.device
    check_args("lw_2stream", dev, specs)
    geo = lw_2stream_geometry(nlay, ngpt, nband if byband else 0)
    shape = (ncol, nlay + 1) + ((nband,) if byband else ())
    up = torch.empty(shape, dtype=f32, device=dev)
    dn = torch.empty_like(up)
    launch("solver_lw_2str", "launch_solver_lw_2str", "lw_2stream",
           tau, ssa, g, lev_source, sfc_emis, sfc_src, inc_flux, gpt2band,
           None if byband else up, None if byband else dn,
           up if byband else None, dn if byband else None, ncol, nlay, ngpt,
           int(nband), geo.chunk)
    lw_2stream.launches += 1
    return up, dn


lw_2stream.launches = 0
