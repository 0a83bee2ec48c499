"""The fused LW step: gas optics + Planck sources + one-angle
no-scattering transport + broadband sum, as the CUDA kernel
``csrc/fused_lw.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/fused_lw.py::
lw_fused_gas_optics_solve`` (semantics of ``_lw_fused_xla_ref``,
models/rrtmgp/gas_optics.py:605-633): per (column, g-point) the 8-corner
major tau and Planck fraction, the minor gases whose window holds the
g-point, the by-band cloud absorption, the Planck lay/lev/sfc sources
from the ``totplnk`` lerp, the down and up sweeps, and the broadband
sum times pi * weight.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`lw_fused_plain`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..gas_optics import (InterpCoeffs, planck_bands, planck_sources,
                          tau_major, tau_minor)
from ..solver_lw import lw_solver_noscat
from ._build import check_args, launch, on_cpu

__all__ = ["LWFusedInputs", "lw_fused", "lw_fused_plain"]


class LWFusedInputs(NamedTuple):
    co: InterpCoeffs               # layer-major (nlay, ncol) cells
    minor_scale: torch.Tensor      # (nminor, nlay, ncol), lower then upper
    minors: tuple                  # per minor: (lower, flavor, g0, width, start)
    minor_meta: torch.Tensor       # (nminor, 5) int32, ``minors`` on device
    kmajor: torch.Tensor           # (ntemp, neta, npres+1, ngpt)
    planck_frac: torch.Tensor      # (ntemp, neta, npres+1, ngpt)
    kminor_lower: torch.Tensor     # (ntemp, neta, ncont_lower)
    kminor_upper: torch.Tensor     # (ntemp, neta, ncont_upper)
    gpoint_flavor: torch.Tensor    # (2, ngpt) int32
    gpt2band: torch.Tensor         # (ngpt,) int32
    totplnk: torch.Tensor          # (nPlanckTemp, nbnd)
    tp_min: float                  # totplnk temperature offset
    tp_delta: float                # totplnk temperature spacing
    tlay: torch.Tensor             # (nlay, ncol)
    tlev: torch.Tensor             # (nlay+1, ncol)
    tsfc: torch.Tensor             # (ncol,)
    sfc_emis: torch.Tensor         # (ngpt, ncol)
    cloud_tau_abs: Optional[torch.Tensor]  # (nbnd, nlay, ncol) or None
    ds: float                      # secant of the quadrature angle
    weight: float                  # quadrature weight


def _split_minors(minors):
    lo = tuple((f, g0, w, s) for (lower, f, g0, w, s) in minors if lower)
    up = tuple((f, g0, w, s) for (lower, f, g0, w, s) in minors if not lower)
    return lo, up


def lw_fused_plain(x: LWFusedInputs):
    """Returns broadband (flux_up, flux_dn), each (nlay+1, ncol)."""
    co = x.co
    tau, pfrac = tau_major(co, x.kmajor, x.planck_frac, x.gpoint_flavor)
    lo, up = _split_minors(x.minors)
    tau = tau_minor(tau, co, x.kminor_lower, lo, x.minor_scale[:len(lo)])
    tau = tau_minor(tau, co, x.kminor_upper, up, x.minor_scale[len(lo):])
    band = x.gpt2band.long()
    if x.cloud_tau_abs is not None:
        tau = tau + x.cloud_tau_abs[band]
    pb = lambda t: planck_bands(t, x.totplnk, tp_min=x.tp_min,
                                tp_delta=x.tp_delta)
    lay, lev, sfc = planck_sources(pfrac, band, pb(x.tlay), pb(x.tlev),
                                   pb(x.tsfc))
    return lw_solver_noscat(tau, lay, lev, x.sfc_emis, sfc, ds=x.ds,
                            weight=x.weight)


def lw_fused(x: LWFusedInputs):
    """:func:`lw_fused_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``lw_fused.launches``)."""
    if on_cpu(x.tlay, "lw_fused"):
        return lw_fused_plain(x)
    co = x.co
    nlay, ncol = x.tlay.shape
    ntemp, neta, npres1, ngpt = x.kmajor.shape
    nflav = co.jeta.shape[1]
    nminor = len(x.minors)
    nbnd = x.totplnk.shape[1]
    ncl, ncu = x.kminor_lower.shape[2], x.kminor_upper.shape[2]
    if ngpt > 1024:
        raise ValueError(f"lw_fused: {ngpt} g-points exceed one CUDA block")
    f32, i32 = torch.float32, torch.int32
    cell = (nlay, ncol)
    specs = {
        "jtemp": (co.jtemp, cell, i32), "ftemp": (co.ftemp, cell, f32),
        "jpress": (co.jpress, cell, i32), "fpress": (co.fpress, cell, f32),
        "tropo": (co.tropo, cell, torch.bool),
        "jeta": (co.jeta, (2, nflav) + cell, i32),
        "feta": (co.feta, (2, nflav) + cell, f32),
        "col_mix": (co.col_mix, (2, nflav) + cell, f32),
        "minor_scale": (x.minor_scale, (nminor,) + cell, f32),
        "minor_meta": (x.minor_meta, (nminor, 5), i32),
        "kmajor": (x.kmajor, (ntemp, neta, npres1, ngpt), f32),
        "planck_frac": (x.planck_frac, (ntemp, neta, npres1, ngpt), f32),
        "kminor_lower": (x.kminor_lower, (ntemp, neta, ncl), f32),
        "kminor_upper": (x.kminor_upper, (ntemp, neta, ncu), f32),
        "gpoint_flavor": (x.gpoint_flavor, (2, ngpt), i32),
        "gpt2band": (x.gpt2band, (ngpt,), i32),
        "totplnk": (x.totplnk, (x.totplnk.shape[0], nbnd), f32),
        "tlay": (x.tlay, cell, f32), "tlev": (x.tlev, (nlay + 1, ncol), f32),
        "tsfc": (x.tsfc, (ncol,), f32),
        "sfc_emis": (x.sfc_emis, (ngpt, ncol), f32)}
    if x.cloud_tau_abs is not None:
        specs["cloud_tau_abs"] = (x.cloud_tau_abs, (nbnd,) + cell, f32)
    check_args("lw_fused", x.tlay.device, specs)
    tropo = co.tropo.to(i32)
    # per-(column, layer, g-point) scratch: tau then transmittance, and
    # Planck fraction then upward source
    scratch = torch.empty((2, ncol, nlay, ngpt), dtype=f32,
                          device=x.tlay.device)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=x.tlay.device)
    dn = torch.empty_like(up)
    launch("fused_lw", "launch_fused_lw", "lw_fused",
           co.jtemp, co.ftemp, co.jpress, co.fpress, tropo, co.jeta,
           co.feta, co.col_mix, x.minor_scale, x.minor_meta, x.kmajor,
           x.planck_frac, x.kminor_lower, x.kminor_upper, x.gpoint_flavor,
           x.gpt2band, x.totplnk, x.tlay, x.tlev, x.tsfc, x.sfc_emis,
           x.cloud_tau_abs, scratch, up, dn,
           ncol, nlay, ngpt, neta, npres1, nflav, nminor, ncl, ncu,
           x.totplnk.shape[0], nbnd, float(x.tp_min), float(x.tp_delta),
           float(x.ds), math.pi * x.weight)
    lw_fused.launches += 1
    return up, dn


lw_fused.launches = 0
