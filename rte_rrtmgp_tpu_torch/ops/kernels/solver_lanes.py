"""The staged branch's lane-layout solves with broadband output: the CUDA
kernels ``csrc/solver_lw.cu`` (launchers ``launch_solver_lw_lanes``,
``launch_solver_lw_pfrac``) and ``csrc/solver_sw.cu``
(``launch_solver_sw_lanes``, ``launch_solver_sw_combined``) and their
plain-PyTorch twins.

Replace the TPU kernels of ``rte_rrtmgp_tpu/ops/pallas/solver_lanes.py``,
with their signatures: spectral fields (ngpt, nlay[+1], ncol), boundary
fields (ngpt, ncol), band fields (nbnd, ...), top at layer 0; fluxes
(nlay+1, ncol). The kernels read every field through its strides, so the
gathers' output passes as a permuted view and a broadcast field as an
expanded one, without copies. Where the TPU kernels take a uniform
``band_width`` (their 8-row g-point block), these take ``gpt2band``
(ngpt,) int32, so ragged bands work too.

The twins run the public-layout solvers (``lw_noscat_plain`` and
``sw_2stream_plain``) on permuted views, after the pfrac-source or the
Rayleigh/cloud-combine prologue of the two solvers that do their own.
A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to the twin. Each wrapper counts its launches. Both kernels
keep a column's layer fields in shared memory
(``solver_lw.lw_noscat_geometry``, ``solver_sw.sw_2stream_geometry``):
on CUDA a column taller than a block holds raises ValueError naming the
limit, and no launch takes device scratch. The staged
branch has no gradient on the card, as the JAX package gives its lane
kernels none: on CUDA the wrappers raise when an input requires grad.
"""
from __future__ import annotations

import numpy as np
import torch

from ...constants import PI
from ..gas_optics import level_pfrac
from ._build import check_strided, launch, on_cpu, strided
from .autodiff import refuse_grad
from .solver_lw import lw_noscat_geometry, lw_noscat_plain
from .solver_sw import sw_2stream_geometry, sw_2stream_plain

__all__ = ["lw_noscat_lanes", "lw_noscat_lanes_plain",
           "lw_noscat_lanes_pfrac", "lw_noscat_lanes_pfrac_plain",
           "sw_2stream_lanes", "sw_2stream_lanes_plain",
           "sw_2stream_lanes_combined", "sw_2stream_lanes_combined_plain",
           "increment_2str_bybnd"]

# the combine's guards are float32's tiny in every dtype, as in the TPU
# kernel (solver_lanes.py:705)
_TINY32 = float(np.finfo(np.float32).tiny)

_pub3 = lambda x: None if x is None else x.permute(2, 1, 0)
_pub2 = lambda x: None if x is None else x.T


def _lw_options(tau, sfc_src, ssa, g, sfc_src_jac, do_rescaling,
                do_jacobians):
    """The TPU kernel's option semantics: rescaling and the Jacobian only
    when asked for, a missing ssa, g or sfc_src_jac read as zeros."""
    zeros = lambda like: like.new_zeros(()).expand(like.shape)
    if do_rescaling:
        ssa = zeros(tau) if ssa is None else ssa
        g = zeros(tau) if g is None else g
    else:
        ssa = g = None
    if do_jacobians:
        sfc_src_jac = zeros(sfc_src) if sfc_src_jac is None else sfc_src_jac
    else:
        sfc_src_jac = None
    return ssa, g, sfc_src_jac


def _no_grad(what, *args):
    refuse_grad(what, *args, hint="the staged lane-layout path "
                "(allsky_staged_lw/sw) is not differentiable on the card; "
                "take gradients through the fused step or the public API")


# ---------------------------------------------------------------------------
# LW no-scattering (row 10) and with in-kernel Planck sources (row 11)
# ---------------------------------------------------------------------------

def lw_noscat_lanes_plain(tau, lay_source, lev_source, sfc_emis, sfc_src,
                          inc_flux, *, ds, weight, ssa=None, g=None,
                          sfc_src_jac=None, do_rescaling=False,
                          do_jacobians=False):
    """tau/lay_source (ngpt, nlay, ncol); lev_source (ngpt, nlay+1, ncol);
    sfc_emis/sfc_src/inc_flux (ngpt, ncol); a scalar secant ``ds``. With
    ``do_rescaling`` Tang rescaling from ssa and g, with ``do_jacobians``
    the surface Jacobian. Returns (flux_up, flux_dn, flux_up_jac or
    None), each (nlay+1, ncol) in W/m2."""
    ssa, g, sfc_src_jac = _lw_options(tau, sfc_src, ssa, g, sfc_src_jac,
                                      do_rescaling, do_jacobians)
    up, dn, jac = lw_noscat_plain(
        _pub3(tau), _pub3(lay_source), _pub3(lev_source), sfc_emis.T,
        sfc_src.T, inc_flux.T, ds=float(ds), weight=weight,
        sfc_src_jac=_pub2(sfc_src_jac), ssa=_pub3(ssa), g=_pub3(g))
    return up.T, dn.T, _pub2(jac)


def lw_noscat_lanes(tau, lay_source, lev_source, sfc_emis, sfc_src,
                    inc_flux, *, ds, weight, ssa=None, g=None,
                    sfc_src_jac=None, do_rescaling=False, do_jacobians=False):
    """:func:`lw_noscat_lanes_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``lw_noscat_lanes.launches``)."""
    if on_cpu(tau, "lw_noscat_lanes"):
        return lw_noscat_lanes_plain(
            tau, lay_source, lev_source, sfc_emis, sfc_src, inc_flux, ds=ds,
            weight=weight, ssa=ssa, g=g, sfc_src_jac=sfc_src_jac,
            do_rescaling=do_rescaling, do_jacobians=do_jacobians)
    ssa, g, sfc_src_jac = _lw_options(tau, sfc_src, ssa, g, sfc_src_jac,
                                      do_rescaling, do_jacobians)
    _no_grad("lw_noscat_lanes", tau, lay_source, lev_source, sfc_emis,
             sfc_src, inc_flux, ssa, g, sfc_src_jac)
    ngpt, nlay, ncol = tau.shape
    f32 = torch.float32
    lay3, bc = (ngpt, nlay, ncol), (ngpt, ncol)
    dev = tau.device
    check_strided("lw_noscat_lanes", dev, {
        "tau": (tau, lay3, f32), "lay_source": (lay_source, lay3, f32),
        "lev_source": (lev_source, (ngpt, nlay + 1, ncol), f32),
        "ssa": (ssa, lay3, f32), "g": (g, lay3, f32),
        "sfc_emis": (sfc_emis, bc, f32), "sfc_src": (sfc_src, bc, f32),
        "sfc_src_jac": (sfc_src_jac, bc, f32),
        "inc_flux": (inc_flux, bc, f32)})
    # the layer fields stay in shared memory: raises past the column
    # height a block holds
    geo = lw_noscat_geometry(nlay, ngpt, rescale=ssa is not None,
                             jacobian=sfc_src_jac is not None)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    jac = None if sfc_src_jac is None else torch.empty_like(up)
    launch("solver_lw", "launch_solver_lw_lanes", "lw_noscat_lanes",
           *strided(tau, 3), *strided(lay_source, 3),
           *strided(lev_source, 3), *strided(ssa, 3), *strided(g, 3),
           *strided(sfc_emis, 2), *strided(sfc_src, 2),
           *strided(sfc_src_jac, 2), *strided(inc_flux, 2),
           up, dn, jac, ncol, nlay, ngpt, float(ds), PI * float(weight),
           geo.chunk)
    lw_noscat_lanes.launches += 1
    return up, dn, jac


lw_noscat_lanes.launches = 0


def lw_noscat_lanes_pfrac_plain(tau, pfrac, pb_lay, pb_lev, pb_sfc,
                                sfc_emis, inc_flux, *, ds, weight, gpt2band,
                                cloud_tau_abs=None):
    """tau/pfrac (ngpt, nlay, ncol); band Planck values pb_lay (nbnd,
    nlay, ncol), pb_lev (nbnd, nlay+1, ncol), pb_sfc (nbnd, ncol);
    sfc_emis/inc_flux (ngpt, ncol); gpt2band (ngpt,) the 0-based band of
    each g-point; cloud_tau_abs (nbnd, nlay, ncol) by-band absorption or
    None. The sources are the Planck fraction times its band's values
    (levels from :func:`level_pfrac`, the surface from the last layer's
    fraction). Returns (flux_up, flux_dn), each (nlay+1, ncol)."""
    band = gpt2band.long()
    if cloud_tau_abs is not None:
        tau = tau + cloud_tau_abs[band]
    lay = pfrac * pb_lay[band]
    lev = level_pfrac(pfrac) * pb_lev[band]
    sfc = pfrac[:, -1] * pb_sfc[band]
    up, dn, _ = lw_noscat_lanes_plain(tau, lay, lev, sfc_emis, sfc,
                                      inc_flux, ds=ds, weight=weight)
    return up, dn


def lw_noscat_lanes_pfrac(tau, pfrac, pb_lay, pb_lev, pb_sfc, sfc_emis,
                          inc_flux, *, ds, weight, gpt2band,
                          cloud_tau_abs=None):
    """:func:`lw_noscat_lanes_pfrac_plain` semantics; on CUDA, one launch
    of the hand-written kernel (counted in
    ``lw_noscat_lanes_pfrac.launches``)."""
    if on_cpu(tau, "lw_noscat_lanes_pfrac"):
        return lw_noscat_lanes_pfrac_plain(
            tau, pfrac, pb_lay, pb_lev, pb_sfc, sfc_emis, inc_flux, ds=ds,
            weight=weight, gpt2band=gpt2band, cloud_tau_abs=cloud_tau_abs)
    _no_grad("lw_noscat_lanes_pfrac", tau, pfrac, pb_lay, pb_lev, pb_sfc,
             sfc_emis, inc_flux, cloud_tau_abs)
    ngpt, nlay, ncol = tau.shape
    nbnd = pb_lay.shape[0]
    f32 = torch.float32
    lay3, bc = (ngpt, nlay, ncol), (ngpt, ncol)
    dev = tau.device
    check_strided("lw_noscat_lanes_pfrac", dev, {
        "tau": (tau, lay3, f32), "pfrac": (pfrac, lay3, f32),
        "pb_lay": (pb_lay, (nbnd, nlay, ncol), f32),
        "pb_lev": (pb_lev, (nbnd, nlay + 1, ncol), f32),
        "pb_sfc": (pb_sfc, (nbnd, ncol), f32),
        "cloud_tau_abs": (cloud_tau_abs, (nbnd, nlay, ncol), f32),
        "sfc_emis": (sfc_emis, bc, f32), "inc_flux": (inc_flux, bc, f32),
        "gpt2band": (gpt2band, (ngpt,), torch.int32)})
    geo = lw_noscat_geometry(nlay, ngpt, pfrac=True)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    launch("solver_lw", "launch_solver_lw_pfrac", "lw_noscat_lanes_pfrac",
           *strided(tau, 3), *strided(pfrac, 3), *strided(pb_lay, 3),
           *strided(pb_lev, 3), *strided(pb_sfc, 2),
           *strided(cloud_tau_abs, 3), *strided(sfc_emis, 2),
           *strided(inc_flux, 2), gpt2band.contiguous(), up, dn, ncol, nlay,
           ngpt, float(ds), PI * float(weight), geo.chunk)
    lw_noscat_lanes_pfrac.launches += 1
    return up, dn


lw_noscat_lanes_pfrac.launches = 0


# ---------------------------------------------------------------------------
# SW two-stream (row 12) and with the in-kernel combine (row 13)
# ---------------------------------------------------------------------------

def sw_2stream_lanes_plain(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                           inc_flux_dir, inc_flux_dif=None):
    """tau/ssa/g (ngpt, nlay, ncol); mu0 (nlay, ncol); albedos and
    incident fluxes (ngpt, ncol), inc_flux_dif None for zero. Returns
    (flux_up, flux_dn total, flux_dir), each (nlay+1, ncol)."""
    up, dn, fdir = sw_2stream_plain(
        _pub3(tau), _pub3(ssa), _pub3(g), mu0.T, sfc_alb_dir.T,
        sfc_alb_dif.T, inc_flux_dir.T, _pub2(inc_flux_dif))
    return up.T, dn.T, fdir.T


def _sw_launch(fn, what, fields, mu0, sfc_alb_dir, sfc_alb_dif,
               inc_flux_dir, inc_flux_dif, gpt2band, ngpt, nlay, ncol):
    dev = mu0.device
    # the layer fields stay in shared memory: raises past the column
    # height a block holds
    geo = sw_2stream_geometry(nlay, ngpt)
    out = torch.empty((3, nlay + 1, ncol), dtype=torch.float32, device=dev)
    extra = () if gpt2band is None else (gpt2band.contiguous(),)
    launch("solver_sw", fn, what,
           *(a for f in fields for a in strided(f, 3)), *strided(mu0, 2),
           *strided(sfc_alb_dir, 2), *strided(sfc_alb_dif, 2),
           *strided(inc_flux_dir, 2), *strided(inc_flux_dif, 2), *extra,
           out, ncol, nlay, ngpt, geo.chunk)
    return out[0], out[1], out[2]


def _sw_specs(ngpt, nlay, ncol, mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
              inc_flux_dif):
    f32, bc = torch.float32, (ngpt, ncol)
    return {"mu0": (mu0, (nlay, ncol), f32),
            "sfc_alb_dir": (sfc_alb_dir, bc, f32),
            "sfc_alb_dif": (sfc_alb_dif, bc, f32),
            "inc_flux_dir": (inc_flux_dir, bc, f32),
            "inc_flux_dif": (inc_flux_dif, bc, f32)}


def sw_2stream_lanes(tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
                     inc_flux_dir, inc_flux_dif=None):
    """:func:`sw_2stream_lanes_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``sw_2stream_lanes.launches``)."""
    if on_cpu(tau, "sw_2stream_lanes"):
        return sw_2stream_lanes_plain(tau, ssa, g, mu0, sfc_alb_dir,
                                      sfc_alb_dif, inc_flux_dir,
                                      inc_flux_dif)
    _no_grad("sw_2stream_lanes", tau, ssa, g, mu0, sfc_alb_dir, sfc_alb_dif,
             inc_flux_dir, inc_flux_dif)
    ngpt, nlay, ncol = tau.shape
    lay3, f32 = (ngpt, nlay, ncol), torch.float32
    bounds = (mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir, inc_flux_dif)
    check_strided("sw_2stream_lanes", tau.device, {
        "tau": (tau, lay3, f32), "ssa": (ssa, lay3, f32),
        "g": (g, lay3, f32), **_sw_specs(ngpt, nlay, ncol, *bounds)})
    out = _sw_launch("launch_solver_sw_lanes", "sw_2stream_lanes",
                     (tau, ssa, g), *bounds, None, ngpt, nlay, ncol)
    sw_2stream_lanes.launches += 1
    return out


sw_2stream_lanes.launches = 0


def increment_2str_bybnd(tau, ssa, cloud, gpt2band, tiny):
    """Gas (tau, ssa, g = 0), each (ngpt, nlay, ncol), incremented by a
    by-band 2-stream (tau, ssa, g), each (nbnd, nlay, ncol), or None: the
    tau-weighted combine of increment_2stream_by_2stream with its _bybnd
    expansion, ``tiny`` guarding the divisions (float32's in the TPU
    kernels, the dtype's in the JAX driver). Returns (tau, ssa, g)."""
    if cloud is None:
        return tau, ssa, torch.zeros_like(tau)
    o_tau, o_ssa, o_g = (x[gpt2band.long()] for x in cloud)
    t = tau + o_tau
    tauscat = tau * ssa + o_tau * o_ssa
    # maximum, not clamp: at a tie the gradient splits half and half, as
    # jnp.maximum's does in the JAX package
    g12 = (o_tau * o_ssa * o_g) / torch.maximum(tauscat, t.new_tensor(tiny))
    ssa12 = tauscat / torch.maximum(t, t.new_tensor(tiny))
    return (t, torch.where(t > 2.0 * tiny, ssa12, ssa),
            torch.where(tauscat > 2.0 * tiny, g12, 0.0))


def sw_2stream_lanes_combined_plain(tau_abs, tau_ray, cloud, mu0,
                                    sfc_alb_dir, sfc_alb_dif, inc_flux_dir,
                                    inc_flux_dif=None, *, gpt2band):
    """tau_abs/tau_ray (ngpt, nlay, ncol) absorption and Rayleigh depths;
    cloud the delta-scaled (tau, ssa, g) by band, each (nbnd, nlay, ncol),
    or None; gpt2band (ngpt,) the 0-based band of each g-point; the rest
    as :func:`sw_2stream_lanes_plain`. The Rayleigh combine and the cloud
    increment come first (JAX solver_lanes.py:704-721, float32 tiny
    guards), then the two-stream solve."""
    t_gas = tau_abs + tau_ray
    big = t_gas > 2.0 * _TINY32
    ssa_gas = torch.where(big, tau_ray / torch.where(big, t_gas, 1.0), 0.0)
    t, w0, g = increment_2str_bybnd(t_gas, ssa_gas, cloud, gpt2band,
                                    _TINY32)
    return sw_2stream_lanes_plain(t, w0, g, mu0, sfc_alb_dir, sfc_alb_dif,
                                  inc_flux_dir, inc_flux_dif)


def sw_2stream_lanes_combined(tau_abs, tau_ray, cloud, mu0, sfc_alb_dir,
                              sfc_alb_dif, inc_flux_dir, inc_flux_dif=None,
                              *, gpt2band):
    """:func:`sw_2stream_lanes_combined_plain` semantics; on CUDA, one
    launch of the hand-written kernel (counted in
    ``sw_2stream_lanes_combined.launches``)."""
    if on_cpu(tau_abs, "sw_2stream_lanes_combined"):
        return sw_2stream_lanes_combined_plain(
            tau_abs, tau_ray, cloud, mu0, sfc_alb_dir, sfc_alb_dif,
            inc_flux_dir, inc_flux_dif, gpt2band=gpt2band)
    _no_grad("sw_2stream_lanes_combined", tau_abs, tau_ray, cloud, mu0,
             sfc_alb_dir, sfc_alb_dif, inc_flux_dir, inc_flux_dif)
    ngpt, nlay, ncol = tau_abs.shape
    lay3, f32 = (ngpt, nlay, ncol), torch.float32
    cloud = (None,) * 3 if cloud is None else tuple(cloud)
    nbnd = 0 if cloud[0] is None else cloud[0].shape[0]
    bounds = (mu0, sfc_alb_dir, sfc_alb_dif, inc_flux_dir, inc_flux_dif)
    check_strided("sw_2stream_lanes_combined", tau_abs.device, {
        "tau_abs": (tau_abs, lay3, f32), "tau_ray": (tau_ray, lay3, f32),
        **{f"cloud_{k}": (c, (nbnd, nlay, ncol), f32)
           for k, c in zip(("tau", "ssa", "g"), cloud)},
        "gpt2band": (gpt2band, (ngpt,), torch.int32),
        **_sw_specs(ngpt, nlay, ncol, *bounds)})
    out = _sw_launch("launch_solver_sw_combined",
                     "sw_2stream_lanes_combined",
                     (tau_abs, tau_ray) + cloud, *bounds, gpt2band, ngpt,
                     nlay, ncol)
    sw_2stream_lanes_combined.launches += 1
    return out


sw_2stream_lanes_combined.launches = 0
