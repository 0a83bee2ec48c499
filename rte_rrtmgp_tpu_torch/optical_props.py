"""Optical property containers and their algebra (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.optical_props`` (reference
``ty_optical_props_{1scl,2str,nstr}``, rte/frontend/mo_optical_props.F90):
dataclasses of tensors shaped ``(ncol, nlay, ngpt)`` (g-points fastest)
plus a static :class:`~rte_rrtmgp_tpu_torch.spectral.SpectralGrid`, and
functions for the algebra: ``increment`` covers the reference's 18-way
dispatch (mo_optical_props.F90:879-1028) with a by-band g-point gather,
``delta_scale`` (mo_optical_props_kernels.F90:47-98), ``subset``,
``to_1scl`` and ``validate``. Each runs on whatever device its tensors
are on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from . import trace
from .config import get_config
from .spectral import SpectralGrid

__all__ = ["OpticalProps1scl", "OpticalProps2str", "OpticalPropsNstr",
           "OpticalProps", "delta_scale", "increment", "subset",
           "expand_to_gpt", "to_1scl", "validate"]


class _Shape:
    @property
    def ncol(self): return self.tau.shape[0]
    @property
    def nlay(self): return self.tau.shape[1]
    @property
    def ngpt(self): return self.tau.shape[2]


@dataclasses.dataclass(frozen=True)
class OpticalProps1scl(_Shape):
    """Absorption-only optical depth (reference ``ty_optical_props_1scl``)."""
    tau: torch.Tensor  # (ncol, nlay, ngpt)
    grid: SpectralGrid
    top_at_1: bool = True


@dataclasses.dataclass(frozen=True)
class OpticalProps2str(_Shape):
    """tau / single-scattering albedo / asymmetry
    (``ty_optical_props_2str``)."""
    tau: torch.Tensor
    ssa: torch.Tensor
    g: torch.Tensor
    grid: SpectralGrid
    top_at_1: bool = True


@dataclasses.dataclass(frozen=True)
class OpticalPropsNstr(_Shape):
    """tau / ssa / phase-function moments ``p (nmom, ncol, nlay, ngpt)``
    (``ty_optical_props_nstr``)."""
    tau: torch.Tensor
    ssa: torch.Tensor
    p: torch.Tensor
    grid: SpectralGrid
    top_at_1: bool = True

    @property
    def nmom(self): return self.p.shape[0]


OpticalProps = Union[OpticalProps1scl, OpticalProps2str, OpticalPropsNstr]


@trace.spanned("optics.delta_scale")
def delta_scale(props: OpticalProps,
                f: Optional[torch.Tensor] = None) -> OpticalProps:
    """Delta-Eddington scaling with forward fraction ``f`` (default g**2;
    reference delta_scale_2str_k / _f_k, kernels :47-98):
    tau' = (1 - ssa f) tau, ssa' = ssa (1 - f) / (1 - ssa f),
    g' = (g - f) / (1 - f). A no-op for absorption-only props."""
    if isinstance(props, OpticalProps1scl):
        return props
    if isinstance(props, OpticalPropsNstr):
        raise NotImplementedError("delta_scale for n-stream not implemented")
    if f is not None and get_config().check_values:
        with trace.wait("delta_scale.f"):
            bad = bool(((f < 0.0) | (f > 1.0)).any())
        if bad:
            raise ValueError("delta_scale: values of f out of bounds [0, 1]")
    g = props.g
    f = g * g if f is None else f
    tiny = torch.finfo(props.tau.dtype).tiny
    wf = props.ssa * f
    tau = (1.0 - wf) * props.tau
    ssa = torch.where(wf < 1.0, (props.ssa - wf)
                      / torch.clamp(1.0 - wf, min=tiny), 0.0)
    gp = torch.where(f < 1.0, (g - f) / torch.clamp(1.0 - f, min=tiny), 0.0)
    return OpticalProps2str(tau=tau, ssa=ssa, g=gp, grid=props.grid,
                            top_at_1=props.top_at_1)


def expand_to_gpt(arr: torch.Tensor, source_grid: SpectralGrid,
                  target_grid: SpectralGrid) -> torch.Tensor:
    """A field stored by band (last axis nband of ``source_grid``) gathered
    onto the target's g-points (the ``_bybnd`` kernels,
    mo_optical_props_kernels.F90:366-630); a g-point field as it is."""
    if arr.shape[-1] == target_grid.ngpt:
        return arr
    if (arr.shape[-1] == source_grid.nband
            and source_grid.bands_are_equal(target_grid)):
        with trace.wait("increment.gpt2band"):
            band = torch.as_tensor(target_grid.gpt2band, dtype=torch.long,
                                   device=arr.device)
        return arr.index_select(-1, band)
    raise ValueError(
        f"increment: incompatible spectral discretizations ({arr.shape[-1]} "
        f"vs target ngpt={target_grid.ngpt} / nband={target_grid.nband})")


@trace.spanned("optics.increment")
def increment(target: OpticalProps, other: OpticalProps) -> OpticalProps:
    """``target += other`` in optical-property space; returns new props.
    Every pairing of {1scl, 2str, nstr}, on the same g-point grid or by
    band (reference increment_* and inc_*_bybnd, kernels :106-630): tau
    adds, ssa averages tau-weighted, g (or the moments) tau*ssa-weighted."""
    grid = target.grid
    tiny = torch.finfo(target.tau.dtype).tiny
    ex = lambda a: expand_to_gpt(a, other.grid, grid)

    o_tau = ex(other.tau)
    if isinstance(other, OpticalProps1scl):
        o_ssa = o_g = None
    elif isinstance(other, OpticalProps2str):
        o_ssa, o_g = ex(other.ssa), ex(other.g)
    else:
        # the first phase moment is the asymmetry parameter (reference
        # increment_2stream_by_nstream uses p2(1))
        o_ssa, o_g = ex(other.ssa), ex(other.p[0])

    if isinstance(target, OpticalProps1scl):
        # absorption only: add tau*(1-ssa) (increment_1scalar_by_2stream)
        add = o_tau if o_ssa is None else o_tau * (1.0 - o_ssa)
        return OpticalProps1scl(tau=target.tau + add, grid=grid,
                                top_at_1=target.top_at_1)

    t_tau, t_ssa = target.tau, target.ssa
    if o_ssa is None:       # 2str/nstr += 1scl
        tau = t_tau + o_tau
        ssa = t_tau * t_ssa / torch.clamp(tau, min=tiny)
        ssa = torch.where(tau > 2.0 * tiny, ssa, t_ssa)
        if isinstance(target, OpticalProps2str):
            return OpticalProps2str(tau=tau, ssa=ssa, g=target.g, grid=grid,
                                    top_at_1=target.top_at_1)
        return OpticalPropsNstr(tau=tau, ssa=ssa, p=target.p, grid=grid,
                                top_at_1=target.top_at_1)

    tau12 = t_tau + o_tau
    tauscat12 = t_tau * t_ssa + o_tau * o_ssa
    ssa12 = tauscat12 / torch.clamp(tau12, min=tiny)
    ssa12 = torch.where(tau12 > 2.0 * tiny, ssa12, t_ssa)
    if isinstance(target, OpticalProps2str):
        # increment_2stream_by_2stream (kernels :199-226)
        t_g = target.g
        o_gv = o_g if o_g is not None else torch.zeros_like(o_tau)
        g12 = (t_tau * t_ssa * t_g + o_tau * o_ssa * o_gv) \
            / torch.clamp(tauscat12, min=tiny)
        g12 = torch.where(tauscat12 > 2.0 * tiny, g12, t_g)
        return OpticalProps2str(tau=tau12, ssa=ssa12, g=g12, grid=grid,
                                top_at_1=target.top_at_1)

    # n-stream target: a 2-stream phase function has moments g**m; blend
    # the common min(nmom) moments, leave the target's higher ones as they
    # are (kernels :325-360)
    t_p = target.p
    if isinstance(other, OpticalProps2str):
        o_p = torch.stack([o_g ** (m + 1) for m in range(t_p.shape[0])])
    else:
        o_p = ex(other.p)
    mom_lim = min(t_p.shape[0], o_p.shape[0])
    blend = ((t_tau * t_ssa * t_p[:mom_lim] + o_tau * o_ssa * o_p[:mom_lim])
             / torch.clamp(tauscat12, min=tiny))
    blend = torch.where(tauscat12 > 2.0 * tiny, blend, t_p[:mom_lim])
    p12 = (blend if mom_lim == t_p.shape[0]
           else torch.cat([blend, t_p[mom_lim:]]))
    return OpticalPropsNstr(tau=tau12, ssa=ssa12, p=p12, grid=grid,
                            top_at_1=target.top_at_1)


def subset(props: OpticalProps, start: int, n: int) -> OpticalProps:
    """Columns [start, start + n) (reference ``get_subset``)."""
    sl = slice(start, start + n)
    if isinstance(props, OpticalProps1scl):
        return dataclasses.replace(props, tau=props.tau[sl])
    if isinstance(props, OpticalProps2str):
        return dataclasses.replace(props, tau=props.tau[sl],
                                   ssa=props.ssa[sl], g=props.g[sl])
    return dataclasses.replace(props, tau=props.tau[sl], ssa=props.ssa[sl],
                               p=props.p[:, sl])


def to_1scl(props: OpticalProps) -> OpticalProps1scl:
    """Absorption optical depth tau (1 - ssa) (reference
    extract_subset_absorption_tau)."""
    if isinstance(props, OpticalProps1scl):
        return props
    return OpticalProps1scl(tau=props.tau * (1.0 - props.ssa),
                            grid=props.grid, top_at_1=props.top_at_1)


@trace.spanned("check.props")
def validate(props: OpticalProps) -> None:
    """Value checks of the reference ``validate()``: tau >= 0 and finite,
    ssa in [0, 1], g in [-1, 1]. Raises ValueError; each check reads one
    boolean back from the device."""
    tau = props.tau
    with trace.wait("props.tau"):
        bad = bool(((tau < 0.0) | ~torch.isfinite(tau)).any())
    if bad:
        raise ValueError("validate: tau values out of range "
                         "(negative or non-finite)")
    if isinstance(props, (OpticalProps2str, OpticalPropsNstr)):
        with trace.wait("props.ssa"):
            bad = bool(((props.ssa < 0.0) | (props.ssa > 1.0)).any())
        if bad:
            raise ValueError("validate: ssa values out of range [0,1]")
    if isinstance(props, OpticalProps2str):
        with trace.wait("props.g"):
            bad = bool(((props.g < -1.0) | (props.g > 1.0)).any())
        if bad:
            raise ValueError("validate: g values out of range [-1,1]")
