"""Minor-gas and Rayleigh optical depths: the CUDA kernels
``csrc/gas_minor.cu`` and their plain-PyTorch twins.

Replace the TPU kernels ``rte_rrtmgp_tpu/ops/pallas/minor_gather.py::
minor_contributions_lane`` (via ``ops/gas_optics_pallas.py::
tau_minor_pallas``; semantics of ``ops/gas_optics.py::tau_minor``,
reference gas_optical_depths_minor) and ``::rayleigh_k_lane`` (via
``tau_rayleigh_pallas``; reference compute_tau_rayleigh), the latter with
the absorption/Rayleigh combine of ``models/rrtmgp/gas_optics.py:344-358``
(reference combine_abs_and_rayleigh).

Both add into ``tau`` (cells of any shape S, then g-points) in place,
or write into a separate ``out`` where one is given, ``tau`` untouched
(:func:`gas_rayleigh` also from no tau: the Rayleigh optical depth
alone). A CUDA tensor goes to the kernel (float32 only; anything else
raises), a CPU tensor to the twin. The kernels have no backward of their
own: on CUDA they refuse inputs that require grad, and gas_optics calls
them out of place, with the twins' gradient (:func:`rayleigh_combine` and
``ops/gas_optics.py::tau_minor``) through ``autodiff.with_twin_grad``.
"""
from __future__ import annotations

import torch

from ..gas_optics import InterpCoeffs, tau_minor, tau_rayleigh
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad

__all__ = ["gas_minor", "gas_minor_plain", "gas_minor_occupancy",
           "gas_rayleigh", "gas_rayleigh_plain", "gas_rayleigh_occupancy",
           "rayleigh_combine"]

_HINT = ("gas_optics differentiates it out of place through "
         "autodiff.with_twin_grad")


def gas_minor_plain(tau, co: InterpCoeffs, kminor, minors, minor_meta,
                    scaling, out=None):
    """Add one atmosphere's minor-gas optical depths into ``tau`` (*S,
    ngpt) in place and return it, or with ``out`` (tau's shape) write tau
    plus them into ``out`` and return that, ``tau`` untouched. kminor
    (ntemp, neta, ncont); minors: one (flavor, g0, width, kminor_start)
    per minor gas; scaling (nminor, *S) from ``minor_scaling`` (atmosphere
    mask applied). ``minor_meta`` (the kernel's copy of ``minors``) is not
    read here."""
    dst = tau if out is None else out
    dst.copy_(tau_minor(tau.movedim(-1, 0), co, kminor, minors,
                        scaling).movedim(0, -1))
    return dst


def gas_minor_occupancy(ngpt: int, nminor: int) -> int:
    """Resident blocks per SM of the kernel at ngpt g-points and nminor
    minors (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the launcher
    starts that many per SM, each taking a run of consecutive cells."""
    return query("gas_minor", "occupancy_gas_minor", ngpt, nminor)


def gas_minor(tau, co: InterpCoeffs, kminor, minors, minor_meta, scaling,
              out=None):
    """:func:`gas_minor_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``gas_minor.launches``), which reads
    tau and writes ``out`` (tau itself without one).
    minor_meta: (nminor, 5) int32 rows (lower, flavor, g0, width, start)
    on the device, the same gases as ``minors``."""
    if on_cpu(tau, "gas_minor"):
        return gas_minor_plain(tau, co, kminor, minors, minor_meta, scaling,
                               out)
    refuse_grad("gas_minor", tau, co, kminor, scaling, out, hint=_HINT)
    cells = tuple(co.jtemp.shape)
    ncell = co.jtemp.numel()
    ngpt = tau.shape[-1]
    ntemp, neta, ncont = kminor.shape
    nflav = co.jeta.shape[1]
    nminor = len(minors)
    if ngpt > 1024:
        raise ValueError(f"gas_minor: {ngpt} g-points exceed one CUDA block")
    f32, i32 = torch.float32, torch.int32
    dst = tau if out is None else out
    check_args("gas_minor", tau.device, {
        "tau": (tau, cells + (ngpt,), f32),
        "out": (dst, cells + (ngpt,), f32),
        "jtemp": (co.jtemp, cells, i32), "ftemp": (co.ftemp, cells, f32),
        "jeta": (co.jeta, (2, nflav) + cells, i32),
        "feta": (co.feta, (2, nflav) + cells, f32),
        "scaling": (scaling, (nminor,) + cells, f32),
        "minor_meta": (minor_meta, (nminor, 5), i32),
        "kminor": (kminor, (ntemp, neta, ncont), f32)})
    launch("gas_minor", "launch_gas_minor", "gas_minor",
           tau, dst, co.jtemp, co.ftemp, co.jeta, co.feta, scaling,
           minor_meta, kminor, ncell, ngpt, neta, nflav, nminor, ncont)
    gas_minor.launches += 1
    return dst


gas_minor.launches = 0


def gas_rayleigh_plain(tau, co: InterpCoeffs, krayl, gpoint_flavor,
                       rayscale, scattering: bool = True, out=None):
    """Add the Rayleigh optical depth (krayl (ntemp, neta, ngpt, 2) in the
    cell's atmosphere, times ``rayscale`` = col_h2o + col_dry, (*S)) into
    ``tau`` (*S, ngpt) in place, or with ``out`` (*S, ngpt) write tau plus
    it into ``out``, ``tau`` untouched; a None ``tau`` (with ``out``)
    reads as 0: the Rayleigh optical depth alone. Returns (tau or out,
    ssa), ssa = tau_rayleigh / that where it exceeds 2 tiny (else 0), or
    None without ``scattering``."""
    if tau is None and out is None:
        raise ValueError("gas_rayleigh: no tau needs an out")
    t, ssa = rayleigh_combine(tau, co, krayl, gpoint_flavor, rayscale,
                              scattering)
    dst = tau if out is None else out
    dst.copy_(t)
    return dst, ssa


def rayleigh_combine(tau, co: InterpCoeffs, krayl, gpoint_flavor, rayscale,
                     scattering: bool = True):
    """:func:`gas_rayleigh_plain` out of place: (tau + tau_rayleigh, ssa or
    None), ``tau`` untouched; a None ``tau`` reads as 0."""
    ray = tau_rayleigh(co, krayl, gpoint_flavor, rayscale).movedim(0, -1)
    t = ray if tau is None else tau + ray
    ssa = None
    if scattering:
        big = t > 2.0 * torch.finfo(t.dtype).tiny
        ssa = torch.where(big, ray / torch.where(big, t, 1.0), 0.0)
    return t, ssa


def gas_rayleigh_occupancy(ngpt: int) -> int:
    """Resident blocks per SM of the Rayleigh kernel at ngpt g-points
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); the launcher starts
    that many per SM, each taking a run of consecutive cells."""
    return query("gas_minor", "occupancy_gas_rayleigh", ngpt)


def gas_rayleigh(tau, co: InterpCoeffs, krayl, gpoint_flavor, rayscale,
                 scattering: bool = True, out=None):
    """:func:`gas_rayleigh_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``gas_rayleigh.launches``), which
    reads tau (nothing where it is None) and writes ``out`` (tau itself
    without one)."""
    ref = tau if tau is not None else rayscale
    if on_cpu(ref, "gas_rayleigh"):
        return gas_rayleigh_plain(tau, co, krayl, gpoint_flavor, rayscale,
                                  scattering, out)
    if tau is None and out is None:
        raise ValueError("gas_rayleigh: no tau needs an out")
    refuse_grad("gas_rayleigh", tau, co, krayl, rayscale, out, hint=_HINT)
    cells = tuple(co.jtemp.shape)
    ncell = co.jtemp.numel()
    ntemp, neta, ngpt, _ = krayl.shape
    nflav = co.jeta.shape[1]
    if ngpt > 1024:
        raise ValueError(f"gas_rayleigh: {ngpt} g-points exceed one CUDA "
                         "block")
    f32, i32 = torch.float32, torch.int32
    dst = tau if out is None else out
    specs = {"out": (dst, cells + (ngpt,), f32)}
    if tau is not None:
        specs["tau"] = (tau, cells + (ngpt,), f32)
    specs.update({
        "jtemp": (co.jtemp, cells, i32), "ftemp": (co.ftemp, cells, f32),
        "tropo": (co.tropo, cells, torch.bool),
        "jeta": (co.jeta, (2, nflav) + cells, i32),
        "feta": (co.feta, (2, nflav) + cells, f32),
        "krayl": (krayl, (ntemp, neta, ngpt, 2), f32),
        "gpoint_flavor": (gpoint_flavor, (2, ngpt), i32),
        "rayscale": (rayscale, cells, f32)})
    check_args("gas_rayleigh", rayscale.device, specs)
    ssa = torch.empty_like(dst) if scattering else None
    launch("gas_minor", "launch_gas_rayleigh", "gas_rayleigh",
           tau, dst, ssa, co.jtemp, co.ftemp, co.tropo, co.jeta, co.feta,
           krayl, gpoint_flavor, rayscale, ncell, ngpt, neta, nflav)
    gas_rayleigh.launches += 1
    return dst, ssa


gas_rayleigh.launches = 0
