"""The fused LW step: gas optics + Planck sources + one-angle
no-scattering transport + broadband sum, as the CUDA kernel
``csrc/fused_lw.cu`` and its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/fused_lw.py::
lw_fused_gas_optics_solve`` (semantics of ``_lw_fused_xla_ref``,
models/rrtmgp/gas_optics.py:605-633): per (column, g-point) the 8-corner
major tau and Planck fraction, the minor gases whose window holds the
g-point, the by-band cloud absorption, the Planck lay/lev/sfc sources
from the ``totplnk`` lerp, the down sweep from the incident flux, the up
sweep, and the broadband sum times pi * weight, or with ``byband`` the
per-band sums (band, level, column). The TPU kernel needs uniform bands
whose width divides 128 for those; the CUDA kernel sums each band's
g-points through ``gpt2band``, and the callers keep the JAX package's
rule of uniform bands.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`lw_fused_plain`. :func:`lw_fused` is differentiable:
its broadband backward is the adjoint kernel ``csrc/fused_lw_bwd.cu``
(:func:`lw_fused_bwd`, replacing the TPU kernel ``ops/pallas/
fused_lw_bwd.py::_lw_fused_bwd``) on CUDA tensors and the twin's gradient
on CPU tensors, with respect to the fields of :data:`LW_DIFF`; the
by-band solve's backward is the twin's gradient on both (the JAX rule,
models/rrtmgp/gas_optics.py:567-570). The tables, the integer indices and
``tropo`` are constants.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..gas_optics import InterpCoeffs, planck_sources, tau_major, tau_minor
from ._build import check_args, launch, on_cpu, query
from .adjoint_segments import segments_on
from .autodiff import none_like, refuse_grad, with_adjoint, with_twin_grad
from .solver_lw import lw_noscat_plain

__all__ = ["LWFusedInputs", "LW_DIFF", "lw_fused", "lw_fused_plain",
           "lw_fused_bwd", "lw_fused_bwd_plain", "lw_fused_bwd_scratch_bytes",
           "lw_fused_bwd_occupancy"]


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
    inc: torch.Tensor              # (ngpt, ncol) incident flux at the top
    cloud_tau_abs: Optional[torch.Tensor]  # (nbnd, nlay, ncol) or None
    ds: float                      # secant of the quadrature angle
    weight: float                  # quadrature weight
    byband: bool = False           # per-band sums instead of broadband


def _split_minors(minors):
    lo = tuple((f, g0, w, s) for (lower, f, g0, w, s) in minors if lower)
    up = tuple((f, g0, w, s) for (lower, f, g0, w, s) in minors if not lower)
    return lo, up


def reverse_axes(a: torch.Tensor) -> torch.Tensor:
    """The public (ncol, nlev[, nband]) fluxes as the fused kernels'
    ([nband,] nlev, ncol), and back."""
    return a.permute(*range(a.ndim - 1, -1, -1))


def lw_fused_plain(x: LWFusedInputs):
    """Returns (flux_up, flux_dn): broadband, each (nlay+1, ncol), or with
    ``x.byband`` the per-band sums, each (nbnd, nlay+1, ncol)."""
    co = x.co
    tau, pfrac = tau_major(co, x.kmajor, x.planck_frac, x.gpoint_flavor)
    lo, up = _split_minors(x.minors)
    tau = tau_minor(tau, co, x.kminor_lower, lo, x.minor_scale[:len(lo)])
    tau = tau_minor(tau, co, x.kminor_upper, up, x.minor_scale[len(lo):])
    if x.cloud_tau_abs is not None:
        tau = tau + x.cloud_tau_abs[x.gpt2band.long()]
    # lane layout (ngpt, nlay, ncol) -> the public (ncol, nlay, ngpt)
    pub = lambda a: a.permute(2, 1, 0)
    sfc, lay, lev, _ = planck_sources(
        pub(pfrac), totplnk=x.totplnk, totplnk_delta=x.tp_delta,
        temp_ref_min=x.tp_min, gpt2band=x.gpt2band, tlay=x.tlay.T,
        tlev=x.tlev.T, tsfc=x.tsfc, top_at_1=True)
    bands = (dict(gpt2band=x.gpt2band, nband=x.totplnk.shape[1])
             if x.byband else {})
    up, dn, _ = lw_noscat_plain(pub(tau), lay, lev, x.sfc_emis.T, sfc,
                                x.inc.T, ds=x.ds, weight=x.weight, **bands)
    return reverse_axes(up), reverse_axes(dn)


# the differentiable inputs, in the order of lw_fused_bwd's cotangents
LW_DIFF = ("co.ftemp", "co.fpress", "co.feta", "co.col_mix", "minor_scale",
           "tlay", "tlev", "tsfc", "sfc_emis", "inc", "cloud_tau_abs")


def _field(x, name):
    for part in name.split("."):
        x = getattr(x, part)
    return x


def _with_fields(x, values: dict):
    """``x`` with the fields named in ``values`` ("co.ftemp", "tlay", ...)
    replaced."""
    co = x.co._replace(**{k[3:]: v for k, v in values.items()
                          if k.startswith("co.")})
    return x._replace(co=co, **{k: v for k, v in values.items()
                                if not k.startswith("co.")})


def _fields_grad(plain, x, names, cotangents):
    """Cotangents of the ``names`` fields of ``x`` (None for an absent one)
    for the ``cotangents`` of ``plain(x)``'s outputs: its autograd,
    recomputed."""
    with torch.enable_grad():
        leaves = {k: _field(x, k).detach().requires_grad_() for k in names
                  if _field(x, k) is not None}
        got = dict(zip(leaves, torch.autograd.grad(
            plain(_with_fields(x, leaves)), tuple(leaves.values()),
            cotangents)))
    return tuple(got.get(k) for k in names)


def _fused_adjoint(bwd, names, x, *grads):
    """The adjoint ``bwd``'s cotangents of the ``names`` fields, as an
    input-shaped template for :func:`autodiff.with_adjoint`."""
    return _with_fields(none_like(x), dict(zip(names, bwd(x, *grads))))


def _check(x: LWFusedInputs, what: str) -> dict:
    """The kernels' shape, dtype and contiguity checks; returns sizes."""
    co = x.co
    nlay, ncol = x.tlay.shape
    ntemp, neta, npres1, ngpt = x.kmajor.shape
    nflav = co.jeta.shape[1]
    nminor = len(x.minors)
    nbnd = x.totplnk.shape[1]
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
        "planck_frac": (x.planck_frac, (ntemp, neta, npres1, ngpt), f32),
        "kminor_lower": (x.kminor_lower, (ntemp, neta, ncl), f32),
        "kminor_upper": (x.kminor_upper, (ntemp, neta, ncu), f32),
        "gpoint_flavor": (x.gpoint_flavor, (2, ngpt), i32),
        "gpt2band": (x.gpt2band, (ngpt,), i32),
        "totplnk": (x.totplnk, (x.totplnk.shape[0], nbnd), f32),
        "tlay": (x.tlay, cell, f32), "tlev": (x.tlev, (nlay + 1, ncol), f32),
        "tsfc": (x.tsfc, (ncol,), f32),
        "sfc_emis": (x.sfc_emis, (ngpt, ncol), f32),
        "inc": (x.inc, (ngpt, ncol), f32)}
    if x.cloud_tau_abs is not None:
        specs["cloud_tau_abs"] = (x.cloud_tau_abs, (nbnd,) + cell, f32)
    check_args(what, x.tlay.device, specs)
    return dict(nlay=nlay, ncol=ncol, ngpt=ngpt, neta=neta, npres1=npres1,
                nflav=nflav, nminor=nminor, nbnd=nbnd, ncl=ncl, ncu=ncu)


def _inputs(x: LWFusedInputs):
    """The launchers' leading arguments: the forward kernel's inputs."""
    co = x.co
    return (co.jtemp, co.ftemp, co.jpress, co.fpress, co.tropo.to(torch.int32),
            co.jeta, co.feta, co.col_mix, x.minor_scale, x.minor_meta,
            x.kmajor, x.planck_frac, x.kminor_lower, x.kminor_upper,
            x.gpoint_flavor, x.gpt2band, x.totplnk, x.tlay, x.tlev, x.tsfc,
            x.sfc_emis, x.inc, x.cloud_tau_abs)


def _sizes(x: LWFusedInputs, n: dict) -> tuple:
    return (n["ncol"], n["nlay"], n["ngpt"], n["neta"], n["npres1"],
            n["nflav"], n["nminor"], n["ncl"], n["ncu"], x.totplnk.shape[0],
            n["nbnd"], float(x.tp_min), float(x.tp_delta), float(x.ds),
            math.pi * x.weight)


def _lw_fused_kernel(x: LWFusedInputs):
    """One launch of the forward kernel (or the twin on CPU tensors)."""
    if on_cpu(x.tlay, "lw_fused"):
        return lw_fused_plain(x)
    n = _check(x, "lw_fused")
    dev = x.tlay.device
    # per-(column, layer, g-point) scratch: tau then transmittance, and
    # Planck fraction then upward source
    scratch = torch.empty((2, n["ncol"], n["nlay"], n["ngpt"]),
                          dtype=torch.float32, device=dev)
    shape = ((n["nbnd"],) if x.byband else ()) + (n["nlay"] + 1, n["ncol"])
    up = torch.empty(shape, dtype=torch.float32, device=dev)
    dn = torch.empty_like(up)
    bb, band = (None, up) if x.byband else (up, None)
    launch("fused_lw", "launch_fused_lw", "lw_fused", *_inputs(x), scratch,
           bb, None if x.byband else dn, band, dn if x.byband else None,
           *_sizes(x, n))
    lw_fused.launches += 1
    return up, dn


def lw_fused_bwd_plain(x: LWFusedInputs, g_up, g_dn):
    """Cotangents of the :data:`LW_DIFF` fields of ``x`` (None for an
    absent cloud) for the cotangents g_up, g_dn (nlay+1, ncol) of
    :func:`lw_fused_plain`'s broadband fluxes: its autograd, recomputed."""
    return _fields_grad(lw_fused_plain, x, LW_DIFF, (g_up, g_dn))


def lw_fused_bwd_scratch_bytes(ncol: int, nlay: int, ngpt: int) -> int:
    """Device scratch of one :func:`lw_fused_bwd` launch: four float32
    fields of (column, layer, g-point), tau, the Planck fraction and the
    transport adjoint's kept radiances and cotangents."""
    return 4 * nlay * ncol * ngpt * 4


def _segments(x):
    """The segment table of x's k-distribution (the fused LW or SW
    inputs) and its launch sizes."""
    segs, table = segments_on(x.gpt2band, x.gpoint_flavor, x.minors,
                              x.co.jeta.shape[1])
    return table, (segs.nrun_band, segs.nrun_minor, int(segs.table[7]))


def lw_fused_bwd_occupancy(x: LWFusedInputs) -> int:
    """Resident blocks per SM of the adjoint kernel at x's sizes (with
    clouds), from cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    _, (nrb, nrm, csr_len) = _segments(x)
    return query("fused_lw_bwd", "occupancy_fused_lw_bwd", x.kmajor.shape[3],
                 x.tlay.shape[0], len(x.minors), nrb, nrm, csr_len)


def lw_fused_bwd(x: LWFusedInputs, g_up, g_dn):
    """:func:`lw_fused_bwd_plain` semantics; on CUDA, one launch of the
    hand-written adjoint kernel (counted in ``lw_fused_bwd.launches``)."""
    if on_cpu(x.tlay, "lw_fused_bwd"):
        return lw_fused_bwd_plain(x, g_up, g_dn)
    refuse_grad("lw_fused_bwd", x, g_up, g_dn,
                hint="the adjoints have no backward of their own")
    if x.byband:
        raise ValueError("lw_fused_bwd: the adjoint kernel takes the "
                         "broadband solve's cotangents")
    n = _check(x, "lw_fused_bwd")
    nlay, ncol, ngpt = n["nlay"], n["ncol"], n["ngpt"]
    dev = x.tlay.device
    f32 = torch.float32
    g_up, g_dn = g_up.contiguous(), g_dn.contiguous()
    check_args("lw_fused_bwd", dev, {"g_up": (g_up, (nlay + 1, ncol), f32),
                                     "g_dn": (g_dn, (nlay + 1, ncol), f32)})
    table, seg_sizes = _segments(x)
    scratch = torch.empty(lw_fused_bwd_scratch_bytes(ncol, nlay, ngpt) // 4,
                          dtype=f32, device=dev)
    co = x.co
    bars = (torch.empty_like(co.ftemp), torch.empty_like(co.fpress),
            torch.empty_like(co.feta), torch.empty_like(co.col_mix),
            torch.empty_like(x.minor_scale), torch.empty_like(x.tlay),
            torch.empty_like(x.tlev), torch.empty_like(x.tsfc),
            torch.empty_like(x.sfc_emis), torch.empty_like(x.inc),
            None if x.cloud_tau_abs is None
            else torch.empty_like(x.cloud_tau_abs))
    ft, fp, fe, cm, ms, tl, tv, ts, em, ib, cl = bars
    launch("fused_lw_bwd", "launch_fused_lw_bwd", "lw_fused_bwd",
           *_inputs(x), g_up, g_dn, table, scratch, ft, fp, fe, cm, ms, cl,
           tl, tv, ts, em, ib, *_sizes(x, n), *seg_sizes)
    lw_fused_bwd.launches += 1
    return bars


lw_fused_bwd.launches = 0


def lw_fused(x: LWFusedInputs):
    """:func:`lw_fused_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``lw_fused.launches``). Differentiable
    with respect to the :data:`LW_DIFF` fields: the broadband backward is
    one launch of the adjoint kernel on CUDA (:func:`lw_fused_bwd`), the
    twin's gradient on the CPU; the by-band backward the twin's gradient on
    both."""
    if x.byband:
        return with_twin_grad(_lw_fused_kernel, lw_fused_plain, x)
    return with_adjoint(
        _lw_fused_kernel, lw_fused_plain,
        lambda a, *g: (_fused_adjoint(lw_fused_bwd, LW_DIFF, *a, *g),), x)


lw_fused.launches = 0
