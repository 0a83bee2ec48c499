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
masking, the direct beam, Shonk-Hogan adding from the diffuse incident
flux, and the broadband sums, or with ``byband`` the per-band sums (band,
level, column). The TPU kernel needs uniform bands whose width divides
128 for those; the CUDA kernel sums each band's g-points through
``gpt2band``, and the callers keep the JAX package's rule of uniform
bands.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`sw_fused_plain`. :func:`sw_fused` is differentiable:
its broadband backward is the adjoint kernel ``csrc/fused_sw_bwd.cu``
(:func:`sw_fused_bwd`, replacing the TPU kernel ``ops/pallas/
fused_sw_bwd.py::_sw_fused_bwd``) on CUDA tensors and the twin's gradient
on CPU tensors, with respect to the fields of :data:`SW_DIFF`; the
by-band solve's backward is the twin's gradient on both (the JAX rule,
models/rrtmgp/gas_optics.py:674-677). The tables, the integer indices and
``tropo`` are constants.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..gas_optics import InterpCoeffs, tau_major, tau_minor, tau_rayleigh
from ._build import check_args, launch, on_cpu, query
from .autodiff import refuse_grad, with_adjoint, with_twin_grad
from .fused_lw import (_fields_grad, _fused_adjoint, _segments,
                       _split_minors, reverse_axes)
from .onchip import Geometry, onchip_geometry
from .solver_lanes import increment_2str_bybnd
from .solver_sw import sw_2stream_plain

__all__ = ["SWFusedInputs", "SW_DIFF", "sw_fused", "sw_fused_plain",
           "sw_fused_geometry", "sw_fused_scratch_bytes",
           "sw_fused_occupancy", "sw_fused_bwd", "sw_fused_bwd_plain",
           "sw_fused_bwd_scratch_bytes", "sw_fused_bwd_occupancy"]

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
    incdif: Optional[torch.Tensor]  # (ngpt, ncol) TOA diffuse flux or None
    byband: bool = False           # per-band sums instead of broadband
    nband: int = 0                 # the bands of gpt2band (by-band output)


def sw_fused_plain(x: SWFusedInputs):
    """Returns (flux_up, flux_dn total, flux_dir): broadband, each
    (nlay+1, ncol), or with ``x.byband`` the per-band sums, each (nband,
    nlay+1, ncol)."""
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
    t, ssa, g = increment_2str_bybnd(t, ssa, x.cloud, x.gpt2band, _TINY32)
    # lane layout (ngpt, nlay, ncol) -> the public (ncol, nlay, ngpt)
    pub = lambda a: a.permute(2, 1, 0)
    bands = dict(gpt2band=x.gpt2band, nband=x.nband) if x.byband else {}
    out = sw_2stream_plain(pub(t), pub(ssa), pub(g), x.mu0.T,
                           x.sfc_alb_dir.T, x.sfc_alb_dif.T, x.inc.T,
                           None if x.incdif is None else x.incdif.T, **bands)
    return tuple(reverse_axes(a) for a in out)


# the differentiable inputs, in the order of sw_fused_bwd's cotangents
SW_DIFF = ("co.ftemp", "co.fpress", "co.feta", "co.col_mix", "minor_scale",
           "rayscale", "cloud", "mu0", "sfc_alb_dir", "sfc_alb_dif", "inc",
           "incdif")


def _check(x: SWFusedInputs, what: str) -> dict:
    """The kernels' shape, dtype and contiguity checks; returns sizes."""
    co = x.co
    nlay, ncol = x.mu0.shape
    ntemp, neta, npres1, ngpt = x.kmajor.shape
    nflav = co.jeta.shape[1]
    nminor = len(x.minors)
    ncl, ncu = x.kminor_lower.shape[2], x.kminor_upper.shape[2]
    if ngpt > 1024:
        raise ValueError(f"{what}: {ngpt} g-points exceed one CUDA block")
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
    if x.incdif is not None:
        specs["incdif"] = (x.incdif, (ngpt, ncol), f32)
    if x.byband and x.nband < 1:
        raise ValueError(f"{what}: by-band output needs nband >= 1")
    check_args(what, x.mu0.device, specs)
    return dict(nlay=nlay, ncol=ncol, ngpt=ngpt, neta=neta, npres1=npres1,
                nflav=nflav, nminor=nminor, ncl=ncl, ncu=ncu,
                nbnd=0 if x.cloud is None else x.cloud.shape[1])


def _inputs(x: SWFusedInputs):
    """The launchers' leading arguments: the forward kernel's inputs."""
    co = x.co
    return (co.jtemp, co.ftemp, co.jpress, co.fpress, co.tropo.to(torch.int32),
            co.jeta, co.feta, co.col_mix, x.minor_scale, x.minor_meta,
            x.kmajor, x.kminor_lower, x.kminor_upper, x.krayl,
            x.gpoint_flavor, x.gpt2band, x.rayscale, x.cloud, x.mu0,
            x.sfc_alb_dir, x.sfc_alb_dif, x.inc, x.incdif)


def _sizes(n: dict) -> tuple:
    return (n["ncol"], n["nlay"], n["ngpt"], n["neta"], n["npres1"],
            n["nflav"], n["nminor"], n["ncl"], n["ncu"], n["nbnd"])


def sw_fused_geometry(x: SWFusedInputs) -> Geometry:
    """Chunk width, cluster size, threads and shared memory per block of
    the forward kernel at x's sizes (:func:`onchip.onchip_geometry`);
    raises ValueError where a column's layer fields do not fit on chip."""
    nlay = x.mu0.shape[0]
    return onchip_geometry("fused_sw", nlay, x.kmajor.shape[3],
                           x.nband if x.byband else 0, len(x.minors))


def sw_fused_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one forward launch: none, the layer fields stay
    in shared memory."""
    return 0


def sw_fused_occupancy(x: SWFusedInputs) -> tuple:
    """(resident blocks per SM, clusters the card holds at once) of the
    forward kernel at x's sizes, from cudaOccupancyMaxActiveBlocksPer
    Multiprocessor and cudaOccupancyMaxActiveClusters."""
    geo = sw_fused_geometry(x)
    n = query("fused_sw", "occupancy_fused_sw", x.mu0.shape[0], geo.chunk,
              geo.nchunk, len(x.minors), x.nband if x.byband else 0)
    return (n // 65536, n % 65536) if n >= 0 else (n, n)


def _sw_fused_kernel(x: SWFusedInputs):
    """One launch of the forward kernel (or the twin on CPU tensors)."""
    if on_cpu(x.mu0, "sw_fused"):
        return sw_fused_plain(x)
    n = _check(x, "sw_fused")
    geo = sw_fused_geometry(x)
    dev = x.mu0.device
    nlay, ncol = n["nlay"], n["ncol"]
    out = torch.empty((3,) + ((x.nband,) if x.byband else ())
                      + (nlay + 1, ncol), dtype=torch.float32, device=dev)
    launch("fused_sw", "launch_fused_sw", "sw_fused", *_inputs(x),
           None if x.byband else out, out if x.byband else None,
           *_sizes(n), int(x.nband), geo.chunk)
    sw_fused.launches += 1
    return out[0], out[1], out[2]


def sw_fused_bwd_plain(x: SWFusedInputs, g_up, g_dn, g_dir):
    """Cotangents of the :data:`SW_DIFF` fields of ``x`` (None for an
    absent cloud or diffuse flux) for the cotangents g_up, g_dn, g_dir
    (nlay+1, ncol) of :func:`sw_fused_plain`'s broadband fluxes: its
    autograd, recomputed."""
    return _fields_grad(sw_fused_plain, x, SW_DIFF, (g_up, g_dn, g_dir))


def sw_fused_bwd_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one :func:`sw_fused_bwd` launch: per (column,
    g-point) the layer optics (tau, ssa, g) and the adjoint's kept
    cotangent per layer, and its four level fields (transport_bwd.cuh::
    SwScratch), in float32."""
    return (4 * nlay + 4 * (nlay + 1)) * ncol * ngpt * 4


def sw_fused_bwd_occupancy(x: SWFusedInputs) -> int:
    """Resident blocks per SM of the adjoint kernel at x's sizes (with
    clouds), from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    _, (nrb, nrm, csr_len) = _segments(x)
    return query("fused_sw_bwd", "occupancy_fused_sw_bwd", x.kmajor.shape[3],
                 x.mu0.shape[0], len(x.minors), nrb, nrm, csr_len)


def sw_fused_bwd(x: SWFusedInputs, g_up, g_dn, g_dir):
    """:func:`sw_fused_bwd_plain` semantics; on CUDA, one launch of the
    hand-written adjoint kernel (counted in ``sw_fused_bwd.launches``)."""
    if on_cpu(x.mu0, "sw_fused_bwd"):
        return sw_fused_bwd_plain(x, g_up, g_dn, g_dir)
    refuse_grad("sw_fused_bwd", x, g_up, g_dn, g_dir,
                hint="the adjoints have no backward of their own")
    if x.byband:
        raise ValueError("sw_fused_bwd: the adjoint kernel takes the "
                         "broadband solve's cotangents")
    n = _check(x, "sw_fused_bwd")
    nlay, ncol, ngpt = n["nlay"], n["ncol"], n["ngpt"]
    dev = x.mu0.device
    f32 = torch.float32
    gs = tuple(g.contiguous() for g in (g_up, g_dn, g_dir))
    check_args("sw_fused_bwd", dev, {
        k: (g, (nlay + 1, ncol), f32)
        for k, g in zip(("g_up", "g_dn", "g_dir"), gs)})
    table, seg_sizes = _segments(x)
    scratch = torch.empty(sw_fused_bwd_scratch_bytes(ncol, nlay, ngpt) // 4,
                          dtype=f32, device=dev)
    co = x.co
    bars = (torch.empty_like(co.ftemp), torch.empty_like(co.fpress),
            torch.empty_like(co.feta), torch.empty_like(co.col_mix),
            torch.empty_like(x.minor_scale), torch.empty_like(x.rayscale),
            None if x.cloud is None else torch.empty_like(x.cloud),
            torch.empty_like(x.mu0), torch.empty_like(x.sfc_alb_dir),
            torch.empty_like(x.sfc_alb_dif), torch.empty_like(x.inc),
            None if x.incdif is None else torch.empty_like(x.incdif))
    launch("fused_sw_bwd", "launch_fused_sw_bwd", "sw_fused_bwd",
           *_inputs(x), *gs, table, scratch, *bars, *_sizes(n), *seg_sizes)
    sw_fused_bwd.launches += 1
    return bars


sw_fused_bwd.launches = 0


def sw_fused(x: SWFusedInputs):
    """:func:`sw_fused_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``sw_fused.launches``). Differentiable
    with respect to the :data:`SW_DIFF` fields: the broadband backward is
    one launch of the adjoint kernel on CUDA (:func:`sw_fused_bwd`), the
    twin's gradient on the CPU; the by-band backward the twin's gradient on
    both."""
    if x.byband:
        return with_twin_grad(_sw_fused_kernel, sw_fused_plain, x,
                              name="sw_fused")
    return with_adjoint(
        _sw_fused_kernel, sw_fused_plain,
        lambda a, *g: (_fused_adjoint(sw_fused_bwd, SW_DIFF, *a, *g),), x,
        name="sw_fused")


sw_fused.launches = 0
