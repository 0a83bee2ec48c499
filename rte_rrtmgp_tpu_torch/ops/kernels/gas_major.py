"""Major-gas optical depth and Planck fraction: the CUDA kernel
``csrc/gas_major.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/major_gather.py::
major_interp_lane`` (via ``ops/gas_optics_pallas.py::tau_major_pallas``;
semantics of ``ops/gas_optics.py::tau_major``, reference
gas_optical_depths_major / interpolate3D_byflav): per cell and g-point
the 8-corner (temperature, eta, pressure) lerp of kmajor times col_mix,
and of the Planck fraction from the same corners.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`gas_major_plain`. With the Planck fraction (LW) the
kernel gathers from kmajor and planck_frac interleaved as one table of
pairs, ``kmajor_pfrac`` (``fused_lw.interleave_kmajor_pfrac``, built once
per k-distribution as ``GasOpticsRRTMGP.kmajor_pfrac``), which the caller
passes; the twin reads the two tables. The kernel has no backward of its
own: on CUDA it refuses inputs that require grad, and callers take the
twin's gradient through ``autodiff.with_twin_grad``.
"""
from __future__ import annotations

import torch

from ..gas_optics import InterpCoeffs, tau_major
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad

__all__ = ["gas_major", "gas_major_plain", "gas_major_occupancy"]


def gas_major_plain(co: InterpCoeffs, kmajor, planck_frac, gpoint_flavor,
                    kmajor_pfrac=None):
    """co: descriptors of cells of any shape S; kmajor/planck_frac
    (ntemp, neta, npres+1, ngpt), planck_frac None for SW; gpoint_flavor
    (2, ngpt); ``kmajor_pfrac`` (the kernel's table) is not read here.
    Returns (tau, pfrac or None), each (*S, ngpt)."""
    tau, pf = tau_major(co, kmajor, planck_frac, gpoint_flavor)
    g_last = lambda x: None if x is None else x.movedim(0, -1).contiguous()
    return g_last(tau), g_last(pf)


def gas_major_occupancy(ngpt: int, planck: bool) -> int:
    """Resident blocks per SM of the kernel at ngpt g-points, with the
    Planck fraction or without (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
    the launcher starts that many per SM, each taking a run of consecutive
    cells."""
    return query("gas_major", "occupancy_gas_major", ngpt, int(planck))


def gas_major(co: InterpCoeffs, kmajor, planck_frac, gpoint_flavor,
              kmajor_pfrac=None):
    """:func:`gas_major_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``gas_major.launches``), which with
    ``planck_frac`` gathers from ``kmajor_pfrac`` (ntemp, neta, npres+1,
    ngpt, 2) and raises without it."""
    if on_cpu(co.ftemp, "gas_major"):
        return gas_major_plain(co, kmajor, planck_frac, gpoint_flavor)
    refuse_grad("gas_major", co, kmajor, planck_frac, kmajor_pfrac,
                hint="gas_optics differentiates it through "
                "autodiff.with_twin_grad")
    if planck_frac is not None and kmajor_pfrac is None:
        raise ValueError("gas_major: kmajor_pfrac is missing; pass the "
                         "k-distribution's interleaved table "
                         "(GasOpticsRRTMGP.kmajor_pfrac)")
    cells = tuple(co.jtemp.shape)
    ncell = co.jtemp.numel()
    ntemp, neta, npres1, ngpt = kmajor.shape
    nflav = co.jeta.shape[1]
    if ngpt > 1024:
        raise ValueError(f"gas_major: {ngpt} g-points exceed one CUDA block")
    f32, i32 = torch.float32, torch.int32
    specs = {
        "jtemp": (co.jtemp, cells, i32), "ftemp": (co.ftemp, cells, f32),
        "jpress": (co.jpress, cells, i32), "fpress": (co.fpress, cells, f32),
        "tropo": (co.tropo, cells, torch.bool),
        "jeta": (co.jeta, (2, nflav) + cells, i32),
        "feta": (co.feta, (2, nflav) + cells, f32),
        "col_mix": (co.col_mix, (2, nflav) + cells, f32),
        "kmajor": (kmajor, (ntemp, neta, npres1, ngpt), f32),
        "gpoint_flavor": (gpoint_flavor, (2, ngpt), i32)}
    if planck_frac is not None:
        specs["planck_frac"] = (planck_frac, tuple(kmajor.shape), f32)
        specs["kmajor_pfrac"] = (kmajor_pfrac, tuple(kmajor.shape) + (2,),
                                 f32)
    dev = co.ftemp.device
    check_args("gas_major", dev, specs)
    tau = torch.empty(cells + (ngpt,), dtype=f32, device=dev)
    pfrac = None if planck_frac is None else torch.empty_like(tau)
    launch("gas_major", "launch_gas_major", "gas_major",
           co.jtemp, co.ftemp, co.jpress, co.fpress, co.tropo.to(i32),
           co.jeta, co.feta, co.col_mix, kmajor,
           None if planck_frac is None else kmajor_pfrac, gpoint_flavor,
           tau, pfrac, ncell, ngpt, neta, npres1, nflav)
    gas_major.launches += 1
    return tau, pfrac


gas_major.launches = 0
