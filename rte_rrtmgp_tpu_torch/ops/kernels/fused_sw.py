"""The fused SW step: gas optics + Rayleigh + cloud increment +
two-stream + adding + broadband sum, as the CUDA kernel
``csrc/fused_sw.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/fused_sw.py::
sw_fused_gas_optics_solve`` (semantics of ``_sw_fused_xla_ref``,
models/rrtmgp/gas_optics.py:712-752): per (column, g-point) the major and
minor absorption, Rayleigh scaled by (col_h2o + col_dry), the
absorption/Rayleigh combine, the by-band delta-scaled cloud 2-stream
increment (with the float32 ``tiny`` guards of the TPU kernel in every
dtype), Meador-Weaver two-stream with the reference's clamps and night
masking, the direct beam, Shonk-Hogan adding, and the broadband sums.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`sw_fused_plain`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..gas_optics import InterpCoeffs, tau_major, tau_minor, tau_rayleigh
from ..solver_sw import sw_solver_2stream
from ._build import check_args, launch, on_cpu
from .fused_lw import _split_minors

__all__ = ["SWFusedInputs", "sw_fused", "sw_fused_plain"]

# the cloud combine's guard is float32's tiny in every dtype, as in the
# TPU kernel (fused_sw.py:47) and its XLA reference (gas_optics.py:734)
_TINY32 = float(np.finfo(np.float32).tiny)


class SWFusedInputs(NamedTuple):
    co: InterpCoeffs               # layer-major (nlay, ncol) cells
    minor_scale: torch.Tensor      # (nminor, nlay, ncol), lower then upper
    minors: tuple                  # per minor: (lower, flavor, g0, width, start)
    minor_meta: torch.Tensor       # (nminor, 5) int32, ``minors`` on device
    kmajor: torch.Tensor           # (ntemp, neta, npres+1, ngpt)
    kminor_lower: torch.Tensor     # (ntemp, neta, ncont_lower)
    kminor_upper: torch.Tensor     # (ntemp, neta, ncont_upper)
    krayl: torch.Tensor            # (ntemp, neta, ngpt, 2)
    gpoint_flavor: torch.Tensor    # (2, ngpt) int32
    gpt2band: torch.Tensor         # (ngpt,) int32
    rayscale: torch.Tensor         # (nlay, ncol) = col_h2o + col_dry
    cloud: Optional[torch.Tensor]  # (3, nbnd, nlay, ncol) delta-scaled
                                   # (tau, ssa, g) by band, or None
    mu0: torch.Tensor              # (nlay, ncol)
    sfc_alb_dir: torch.Tensor      # (ngpt, ncol)
    sfc_alb_dif: torch.Tensor      # (ngpt, ncol)
    inc: torch.Tensor              # (ngpt, ncol) TOA direct flux


def sw_fused_plain(x: SWFusedInputs):
    """Returns broadband (flux_up, flux_dn total, flux_dir), each
    (nlay+1, ncol)."""
    co = x.co
    tau, _ = tau_major(co, x.kmajor, None, x.gpoint_flavor)
    lo, up = _split_minors(x.minors)
    tau = tau_minor(tau, co, x.kminor_lower, lo, x.minor_scale[:len(lo)])
    tau = tau_minor(tau, co, x.kminor_upper, up, x.minor_scale[len(lo):])
    ray = tau_rayleigh(co, x.krayl, x.gpoint_flavor, x.rayscale)
    # combine_abs_and_rayleigh (reference :1954-2036)
    t = tau + ray
    tiny = torch.finfo(t.dtype).tiny
    big = t > 2.0 * tiny
    ssa = torch.where(big, ray / torch.where(big, t, 1.0), 0.0)
    g = torch.zeros_like(t)
    if x.cloud is not None:
        # increment_2stream_by_2stream by band (gas g is zero)
        band = x.gpt2band.long()
        ct, cs, cg = x.cloud[0][band], x.cloud[1][band], x.cloud[2][band]
        t12 = t + ct
        tauscat = t * ssa + ct * cs
        g12 = (t * ssa * g + ct * cs * cg) / torch.clamp(tauscat, min=_TINY32)
        ssa12 = tauscat / torch.clamp(t12, min=_TINY32)
        g = torch.where(tauscat > 2.0 * _TINY32, g12, 0.0)
        ssa = torch.where(t12 > 2.0 * _TINY32, ssa12, ssa)
        t = t12
    return sw_solver_2stream(t, ssa, g, x.mu0, x.sfc_alb_dir, x.sfc_alb_dif,
                             x.inc)


def sw_fused(x: SWFusedInputs):
    """:func:`sw_fused_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``sw_fused.launches``)."""
    if on_cpu(x.mu0, "sw_fused"):
        return sw_fused_plain(x)
    co = x.co
    nlay, ncol = x.mu0.shape
    ntemp, neta, npres1, ngpt = x.kmajor.shape
    nflav = co.jeta.shape[1]
    nminor = len(x.minors)
    ncl, ncu = x.kminor_lower.shape[2], x.kminor_upper.shape[2]
    if ngpt > 1024:
        raise ValueError(f"sw_fused: {ngpt} g-points exceed one CUDA block")
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
        "kminor_lower": (x.kminor_lower, (ntemp, neta, ncl), f32),
        "kminor_upper": (x.kminor_upper, (ntemp, neta, ncu), f32),
        "krayl": (x.krayl, (ntemp, neta, ngpt, 2), f32),
        "gpoint_flavor": (x.gpoint_flavor, (2, ngpt), i32),
        "gpt2band": (x.gpt2band, (ngpt,), i32),
        "rayscale": (x.rayscale, cell, f32), "mu0": (x.mu0, cell, f32),
        "sfc_alb_dir": (x.sfc_alb_dir, (ngpt, ncol), f32),
        "sfc_alb_dif": (x.sfc_alb_dif, (ngpt, ncol), f32),
        "inc": (x.inc, (ngpt, ncol), f32)}
    if x.cloud is not None:
        specs["cloud"] = (x.cloud, (3, x.cloud.shape[1]) + cell, f32)
    check_args("sw_fused", x.mu0.device, specs)
    tropo = co.tropo.to(i32)
    # per-(column, level, g-point) scratch: rdif, tdif, source_dn,
    # source_up (then the adding denominator), albedo, source
    scratch = torch.empty((6, ncol, nlay + 1, ngpt), dtype=f32,
                          device=x.mu0.device)
    out = torch.empty((3, nlay + 1, ncol), dtype=f32, device=x.mu0.device)
    launch("fused_sw", "launch_fused_sw", "sw_fused",
           co.jtemp, co.ftemp, co.jpress, co.fpress, tropo, co.jeta,
           co.feta, co.col_mix, x.minor_scale, x.minor_meta, x.kmajor,
           x.kminor_lower, x.kminor_upper, x.krayl, x.gpoint_flavor,
           x.gpt2band, x.rayscale, x.cloud, x.mu0, x.sfc_alb_dir,
           x.sfc_alb_dif, x.inc, scratch, out,
           ncol, nlay, ngpt, neta, npres1, nflav, nminor, ncl, ncu,
           0 if x.cloud is None else x.cloud.shape[1])
    sw_fused.launches += 1
    return out[0], out[1], out[2]


sw_fused.launches = 0
