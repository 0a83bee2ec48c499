"""SW two-stream solve with broadband or per-band output: the CUDA kernel
``csrc/solver_sw.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py::
sw_two_stream_broadband_lane`` (semantics of ``ops/solver_sw.py``'s XLA
two-stream, reference mo_rte_solver_kernels.F90:503-609, 985-1127): per
(column, g-point) the Meador-Weaver coefficients with the reference's
clamps, night masking by mu0 > 0 per layer, the direct beam, Shonk-Hogan
adding from the diffuse flux at the top, and the broadband sums, or with
``gpt2band`` the per-band sums. The TPU kernel sums bands only when they
are uniform and their width divides 128; here any band of each g-point
works.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`sw_2stream_plain`. The kernel keeps a column's layer
fields in shared memory (:func:`sw_2stream_geometry`), so on CUDA the
column height is bounded and a taller one raises ValueError naming the
limit; the twin has no limit. The kernel has no backward of its
own: on CUDA it refuses inputs that require grad; ``ops/solver_sw.py``
differentiates it through ``solver_sw_bwd.sw_2stream_vjp``.
"""
from __future__ import annotations

import torch

from ...fluxes import sum_bands
from ..solver_sw import two_stream
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad
from .onchip import Geometry, onchip_geometry

__all__ = ["sw_2stream", "sw_2stream_plain", "sw_2stream_geometry",
           "sw_2stream_scratch_bytes", "sw_2stream_occupancy"]


def sw_2stream_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                     inc_flux_dir, inc_flux_dif=None, gpt2band=None, *,
                     nband: int = 0):
    """tau/ssa/g (ncol, nlay, ngpt), top at layer 0; mu0 (ncol, nlay);
    albedos and incident fluxes (ncol, ngpt), inc_flux_dif None for zero.
    Returns (flux_up, flux_dn total = diffuse + direct, flux_dir):
    broadband, each (ncol, nlay+1), or with ``gpt2band`` (ngpt,) the
    per-band sums (ncol, nlay+1, nband)."""
    if gpt2band is None:
        return two_stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                          inc_flux_dir, inc_flux_dif)
    return tuple(sum_bands(f, gpt2band, nband) for f in two_stream(
        tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
        inc_flux_dif, spectral=True))


def sw_2stream_geometry(nlay: int, ngpt: int, nband: int = 0) -> Geometry:
    """Chunk width, cluster size, threads and shared memory per block of
    the kernel (all three launchers) at nlay layers, ngpt g-points and
    nband bands (0: broadband) (:func:`onchip.onchip_geometry`); raises
    ValueError where a column's layer fields do not fit on chip."""
    return onchip_geometry("solver_sw", nlay, ngpt, nband)


def sw_2stream_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one launch of any of the three launchers: none,
    the layer fields stay in shared memory."""
    return 0


def sw_2stream_occupancy(nlay: int, ngpt: int, nband: int = 0,
                         combined: bool = False) -> tuple:
    """(resident blocks per SM, clusters the card holds at once) of the
    kernel (``combined``: the COMBINED instantiation of
    ``launch_solver_sw_combined``) at these sizes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor and
    cudaOccupancyMaxActiveClusters."""
    geo = sw_2stream_geometry(nlay, ngpt, nband)
    n = query("solver_sw", "occupancy_solver_sw", nlay, geo.chunk,
              geo.nchunk, nband, int(combined))
    return (n // 65536, n % 65536) if n >= 0 else (n, n)


def sw_2stream(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
               inc_flux_dif=None, gpt2band=None, *, nband: int = 0):
    """:func:`sw_2stream_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``sw_2stream.launches``)."""
    if on_cpu(tau, "sw_2stream"):
        return sw_2stream_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                                inc_flux_dir, inc_flux_dif, gpt2band,
                                nband=nband)
    refuse_grad("sw_2stream", tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                inc_flux_dir, inc_flux_dif, hint="ops/solver_sw."
                "sw_solver_2stream differentiates it (solver_sw_bwd."
                "sw_2stream_vjp)")
    ncol, nlay, ngpt = tau.shape
    f32 = torch.float32
    lay3, bc = (ncol, nlay, ngpt), (ncol, ngpt)
    specs = {"tau": (tau, lay3, f32), "ssa": (ssa, lay3, f32),
             "g": (g, lay3, f32), "mu0": (mu0, (ncol, nlay), f32),
             "sfc_alb_dir": (sfc_alb_dir, bc, f32),
             "sfc_alb_dif": (sfc_alb_dif, bc, f32),
             "inc_flux_dir": (inc_flux_dir, bc, f32)}
    if inc_flux_dif is not None:
        specs["inc_flux_dif"] = (inc_flux_dif, bc, f32)
    byband = gpt2band is not None
    if byband:
        if nband < 1:
            raise ValueError("sw_2stream: by-band output needs nband >= 1")
        specs["gpt2band"] = (gpt2band, (ngpt,), torch.int32)
    dev = tau.device
    check_args("sw_2stream", dev, specs)
    geo = sw_2stream_geometry(nlay, ngpt, nband if byband else 0)
    out = torch.empty((3, ncol, nlay + 1) + ((nband,) if byband else ()),
                      dtype=f32, device=dev)
    launch("solver_sw", "launch_solver_sw", "sw_2stream",
           tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
           inc_flux_dif, gpt2band, None if byband else out,
           out if byband else None, ncol, nlay, ngpt, int(nband), geo.chunk)
    sw_2stream.launches += 1
    return out[0], out[1], out[2]


sw_2stream.launches = 0
