"""Longwave solvers and the adding method (plain PyTorch).

Counterpart of ``rte_rrtmgp_tpu.ops.solver_lw`` (reference
rte/kernels/mo_rte_solver_kernels.F90): ``lw_source_noscat`` (:620-675),
the one-angle emission/absorption solve with Tang rescaling and the
surface Jacobian (:51-240), the multi-angle ``lw_solver_noscat``
(:248-367), the true two-stream solve ``lw_solver_2stream`` (:377-440,
with ``lw_two_stream`` :854-909 and ``lw_source_2str`` :917-967) and
Shonk-Hogan ``adding`` (:1135-1245).

Public fields are (ncol, nlay[+1], ngpt) with the layer on axis 1; the
layer recurrences are Python loops over (ncol, ngpt) slices. Broadband
and by-band output go through the hand-written kernels on a CUDA tensor:
``ops/kernels/solver_lw`` (one angle of the no-scattering solve) and
``ops/kernels/solver_lw_2str`` (the two-stream solve).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..constants import PI

__all__ = ["GAUSS_DS", "GAUSS_WTS", "LWFluxes", "lw_source_noscat",
           "lw_solver_noscat", "lw_two_stream", "lw_source_2str",
           "two_stream_lw", "lw_solver_2stream", "adding"]

# "Gauss-Jacobi-5" quadrature secants and weights (Hogan 2023 Table 1;
# reference mo_rte_lw.F90:135-160): GAUSS_DS[n-1][k] is the k-th secant
# of the n-point rule
_MUS = (
    (0.6096748751,),
    (0.2509907356, 0.7908473988),
    (0.1024922169, 0.4417960320, 0.8633751621),
    (0.0454586727, 0.2322334416, 0.5740198775, 0.9030775973),
)
GAUSS_DS = tuple(tuple(1.0 / m for m in row) for row in _MUS)
GAUSS_WTS = (
    (1.0,),
    (0.2300253764, 0.7699746236),
    (0.0437820218, 0.3875796738, 0.5686383044),
    (0.0092068785, 0.1285704278, 0.4323381850, 0.4298845087),
)


class LWFluxes(NamedTuple):
    flux_up: torch.Tensor                 # (ncol, nlev), (ncol, nlev, nband)
    flux_dn: torch.Tensor                 # or (ncol, nlev, ngpt)
    flux_up_jac: Optional[torch.Tensor]   # (ncol, nlev) broadband, or None


def lw_source_noscat(lay_source, lev_top, lev_bot, tau, trans):
    """Linear-in-tau layer emission toward each face (Clough et al. 1992
    Eq 13, with the small-tau series of :652-655). Returns (source_dn,
    source_up): "dn" exits the layer bottom, "up" its top."""
    finfo = torch.finfo(tau.dtype)
    tau_thresh = math.sqrt(math.sqrt(finfo.eps))
    safe_tau = torch.maximum(tau, tau.new_tensor(finfo.tiny))
    fact_big = (1.0 - trans) / safe_tau - trans
    fact_small = tau * (0.5 + tau * (-1.0 / 3.0 + tau * (1.0 / 8.0)))
    fact = torch.where(tau > tau_thresh, fact_big, fact_small)
    source_dn = (1.0 - trans) * lev_bot + 2.0 * fact * (lay_source - lev_bot)
    source_up = (1.0 - trans) * lev_top + 2.0 * fact * (lay_source - lev_top)
    return source_dn, source_up


def _oneangle(tau, lay_source, lev_source, sfc_emis, sfc_src, inc_flux, ds,
              weight, sfc_src_jac=None, ssa=None, g=None, spectral=False):
    """One-angle emission/absorption solve, top at index 0 (reference
    :51-240). tau/lay_source (ncol, nlay, ngpt), lev_source
    (ncol, nlay+1, ngpt), boundary fields (ncol, ngpt); ``ds`` a secant (a
    float or a 0-d tensor) or (ncol, ngpt) secants. With ssa and g, Tang
    (2018) rescaling; with sfc_src_jac, the surface Jacobian. Returns (up, dn, jac) radiances,
    summed over g-points unless ``spectral`` (jac always summed; None
    without sfc_src_jac); the caller multiplies by pi * weight."""
    nlay = tau.shape[1]
    rescale = ssa is not None
    if isinstance(ds, torch.Tensor) and ds.ndim == 2:
        ds = ds[:, None, :]
    tau_loc = tau * ds
    if rescale:
        # similarity-principle rescaling (reference :148-178)
        wb = ssa * (1.0 - g) * 0.5
        scale_tau = 1.0 - ssa + wb
        cn = 0.4 * wb / scale_tau
        tau_loc = tau_loc * scale_tau
    trans = torch.exp(-tau_loc)
    an = 1.0 - trans * trans if rescale else None
    sdn, sup = lw_source_noscat(lay_source, lev_source[:, :-1],
                                lev_source[:, 1:], tau_loc, trans)

    # down (reference lw_transport_noscat_dn :681-708), surface (:198-202)
    radn_dn = [inc_flux / (PI * weight)]
    for l in range(nlay):
        radn_dn.append(trans[:, l] * radn_dn[-1] + sdn[:, l])
    radn_up = [radn_dn[-1] * (1.0 - sfc_emis) + sfc_emis * sfc_src]
    jac = None if sfc_src_jac is None else [sfc_emis * sfc_src_jac]
    for l in range(nlay - 1, -1, -1):
        r = trans[:, l] * radn_up[-1] + sup[:, l]
        if rescale:
            # Tang adjustment from the downwelling radiance at the layer's
            # top edge (reference lw_transport_1rescl :784-793)
            r = r + cn[:, l] * (an[:, l] * radn_dn[l]
                                - trans[:, l] * sdn[:, l] - sup[:, l])
        radn_up.append(r)
        if jac is not None:
            jac.append(trans[:, l] * jac[-1])
    radn_up.reverse()
    if rescale:
        # second down sweep, adjusted from the upwelling field (:798-808)
        radn_dn = radn_dn[:1]
        for l in range(nlay):
            adj = cn[:, l] * (an[:, l] * radn_up[l] - trans[:, l] * sup[:, l]
                              - sdn[:, l])
            radn_dn.append(trans[:, l] * radn_dn[-1] + sdn[:, l] + adj)
    up = torch.stack(radn_up, dim=1)
    dn = torch.stack(radn_dn, dim=1)
    if jac is not None:
        jac.reverse()
        jac = torch.stack(jac, dim=1).sum(-1)
    if not spectral:
        up, dn = up.sum(-1), dn.sum(-1)
    return up, dn, jac


def _one_angle(solve, weight, nband):
    """``solve`` (lw_noscat or its twin) on positional (tau, lay, lev,
    sfc_emis, sfc_src, inc_flux, ds, sfc_src_jac, ssa, g, gpt2band), the
    weight bound now: a Function's backward calls it after the angle loop
    has moved on."""
    return lambda *a: solve(*a[:6], ds=a[6], weight=weight,
                            sfc_src_jac=a[7], ssa=a[8], g=a[9],
                            gpt2band=a[10], nband=nband)


def _secants(ds, nangle, ncol, ngpt):
    """The per-angle secants of ``ds``: a sequence of nangle entries, each
    a float or a 0-d tensor (one secant) or an (ncol, ngpt) tensor (a
    secant field); or a tensor: 1-D (one secant per angle), (ncol, ngpt)
    (one angle's field) or (nangle, ncol, ngpt). Returns a list of floats,
    0-d tensors and (ncol, ngpt) tensors (the JAX package's rule,
    ops/solver_lw.py:262-281)."""
    if isinstance(ds, torch.Tensor):
        ds = ds.unbind(0) if ds.ndim in (1, 3) else (ds,)
    out = []
    for d in ds:
        if not isinstance(d, torch.Tensor):
            out.append(float(d))
        elif d.ndim == 2 and tuple(d.shape) == (ncol, ngpt):
            out.append(d)
        elif d.numel() == 1 and d.ndim <= 1:
            out.append(d.reshape(()))
        else:
            raise ValueError(f"lw_solver_noscat: a secant of shape "
                             f"{tuple(d.shape)}; expected a scalar or "
                             f"{(ncol, ngpt)}")
    if len(out) != nangle:
        raise ValueError(f"lw_solver_noscat: {len(out)} secants for "
                         f"{nangle} weights")
    return out


def lw_solver_noscat(tau, lay_source, lev_source, sfc_emis, sfc_src,
                     inc_flux, *, top_at_1: bool, ds, weights,
                     sfc_src_jac=None, ssa=None, g=None,
                     do_rescaling: bool = False, do_jacobians: bool = False,
                     spectral: bool = False, gpt2band=None,
                     nband: int = 0) -> LWFluxes:
    """Multi-angle no-scattering LW solve (reference rte_lw_solver_noscat,
    :248-367): one one-angle solve per quadrature angle, summed. ``ds``:
    per-angle secants (see :func:`_secants`: scalars, as floats or 0-d
    tensors, or (ncol, ngpt) fields); ``weights`` the quadrature weights.
    Broadband output, or per-band sums (ncol, nlay+1, nband) with
    ``gpt2band`` (int32, 0-based band of each g-point) and ``nband``, goes
    through the one-angle kernel (``ops/kernels/solver_lw``: the CUDA
    kernel on a CUDA tensor, its plain twin on a CPU one); ``spectral``
    output is plain tensor code. The Jacobian is broadband. Fluxes in
    W/m2. Differentiable: one angle with a constant scalar secant, no
    rescaling, no Jacobian and broadband output takes the adjoint kernel
    on the backward (``solver_lw_bwd.lw_noscat_vjp``, the JAX dispatch
    rule of ops/solver_lw.py:338-350), any other solve the twin's
    gradient (a secant that requires grad included)."""
    from .kernels.autodiff import with_twin_grad
    from .kernels.solver_lw import lw_noscat, lw_noscat_plain
    from .kernels.solver_lw_bwd import lw_noscat_vjp

    ncol, _, ngpt = tau.shape
    ds = _secants(ds, len(weights), ncol, ngpt)

    if not top_at_1:
        flip = lambda x: None if x is None else torch.flip(x, [1])
        tau, lay_source, lev_source = flip(tau), flip(lay_source), \
            flip(lev_source)
        ssa, g = flip(ssa), flip(g)
    if do_rescaling and (ssa is None or g is None):
        raise ValueError("do_rescaling requires ssa and g")
    if not do_rescaling:
        ssa = g = None
    if do_jacobians and sfc_src_jac is None:
        sfc_src_jac = torch.zeros_like(sfc_src)
    if not do_jacobians:
        sfc_src_jac = None
    up = dn = jac = None
    for d, w in zip(ds, weights):
        if (isinstance(d, torch.Tensor) and d.ndim == 0
                and not (d.requires_grad and torch.is_grad_enabled())):
            d = float(d)          # a constant scalar secant
        if spectral:
            u, dd, j = _oneangle(tau, lay_source, lev_source, sfc_emis,
                                 sfc_src, inc_flux, d, float(w), sfc_src_jac,
                                 ssa, g, spectral=True)
            piw = PI * float(w)
            u, dd = u * piw, dd * piw
            j = None if j is None else j * piw
        else:
            c = lambda x: x.contiguous() if isinstance(x, torch.Tensor) else x
            fields = tuple(c(x) for x in (tau, lay_source, lev_source,
                                          sfc_emis, sfc_src, inc_flux))
            if (len(weights) == 1 and not isinstance(d, torch.Tensor)
                    and ssa is None and sfc_src_jac is None
                    and gpt2band is None):
                (u, dd), j = lw_noscat_vjp(*fields, ds=d,
                                           weight=float(w)), None
            else:
                u, dd, j = with_twin_grad(
                    _one_angle(lw_noscat, float(w), nband),
                    _one_angle(lw_noscat_plain, float(w), nband), *fields,
                    c(d), c(sfc_src_jac), c(ssa), c(g), gpt2band,
                    name="lw_noscat")
        up = u if up is None else up + u
        dn = dd if dn is None else dn + dd
        jac = j if jac is None else jac + j
    if not top_at_1:
        up, dn = torch.flip(up, [1]), torch.flip(dn, [1])
        jac = None if jac is None else torch.flip(jac, [1])
    return LWFluxes(flux_up=up, flux_dn=dn, flux_up_jac=jac)


def adding(albedo_sfc, rdif, tdif, src_dn, src_up, src_sfc, flux_dn_top):
    """Shonk & Hogan 2008 adding for diffuse transport (Eqs 9-13), top at
    index 0: rdif/tdif/src_* (ncol, nlay, ngpt); albedo_sfc/src_sfc/
    flux_dn_top (ncol, ngpt). Returns (flux_up, flux_dn), each
    (ncol, nlay+1, ngpt)."""
    nlay = rdif.shape[1]
    albedo = [None] * (nlay + 1)
    src = [None] * (nlay + 1)
    denom = [None] * nlay
    albedo[nlay], src[nlay] = albedo_sfc, src_sfc
    for v in range(nlay - 1, -1, -1):
        r, t = rdif[:, v], tdif[:, v]
        denom[v] = 1.0 / (1.0 - r * albedo[v + 1])                     # Eq 10
        albedo[v] = r + t * t * albedo[v + 1] * denom[v]                # Eq 9
        src[v] = src_up[:, v] + t * denom[v] * (
            src[v + 1] + albedo[v + 1] * src_dn[:, v])                  # Eq 11
    fdn = [flux_dn_top]
    fup = [flux_dn_top * albedo[0] + src[0]]                            # Eq 12
    for v in range(nlay):
        f = (tdif[:, v] * fdn[-1] + rdif[:, v] * src[v + 1]
             + src_dn[:, v]) * denom[v]                                 # Eq 13
        fdn.append(f)
        fup.append(f * albedo[v + 1] + src[v + 1])
    return torch.stack(fup, dim=1), torch.stack(fdn, dim=1)


# ---------------------------------------------------------------------------
# Two-stream LW
# ---------------------------------------------------------------------------

def lw_two_stream(tau, w0, g):
    """Meador-Weaver diffuse reflectance and transmittance with the LW
    diffusivity secant 1.66 (Fu et al. 1997 Eqs 2.9-2.10; reference
    lw_two_stream, :854-909). Returns gamma1, gamma2, Rdif, Tdif."""
    lw_diff_sec = 1.66
    gamma1 = lw_diff_sec * (1.0 - 0.5 * w0 * (1.0 + g))
    gamma2 = lw_diff_sec * 0.5 * w0 * (1.0 - g)
    # maximum rather than clamp: JAX's half-and-half gradient at a tie
    k = torch.sqrt(torch.maximum((gamma1 - gamma2) * (gamma1 + gamma2),
                                 tau.new_tensor(1e-12)))
    e1 = torch.exp(-tau * k)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
    rdif = rt * gamma2 * (1.0 - e2)
    tdif = rt * 2.0 * k * e1
    return gamma1, gamma2, rdif, tdif


def lw_source_2str(sfc_emis, sfc_src, lay_source, lev_top, lev_bot,
                   gamma1, gamma2, rdif, tdif, tau):
    """Toon et al. 1989 Eqs 26-27 linear-in-B two-stream sources times pi
    (reference lw_source_2str, :917-967), zero where tau <= 1e-8. The
    layer source is not used by the linear-in-B form. Returns (src_dn,
    src_up, src_sfc)."""
    safe = tau * (gamma1 + gamma2)
    z = (lev_bot - lev_top) / torch.where(safe > 0, safe, 1.0)
    zup_top = z + lev_top
    zup_bot = z + lev_bot
    zdn_top = -z + lev_top
    zdn_bot = -z + lev_bot
    src_up = PI * (zup_top - rdif * zdn_top - tdif * zup_bot)
    src_dn = PI * (zdn_bot - rdif * zup_bot - tdif * zdn_top)
    thin = tau <= 1.0e-8
    src_up = torch.where(thin, 0.0, src_up)
    src_dn = torch.where(thin, 0.0, src_dn)
    src_sfc = PI * sfc_emis * sfc_src
    return src_dn, src_up, src_sfc


def two_stream_lw(tau, ssa, g, lev_source, sfc_emis, sfc_src, inc_flux):
    """The two-stream solve per g-point, top at index 0: coefficients,
    sources and adding from the surface albedo 1 - emis and the incident
    flux. Returns (flux_up, flux_dn), each (ncol, nlay+1, ngpt)."""
    gamma1, gamma2, rdif, tdif = lw_two_stream(tau, ssa, g)
    src_dn, src_up, src_sfc = lw_source_2str(
        sfc_emis, sfc_src, None, lev_source[:, :-1], lev_source[:, 1:],
        gamma1, gamma2, rdif, tdif, tau)
    return adding(1.0 - sfc_emis, rdif, tdif, src_dn, src_up, src_sfc,
                  inc_flux)


def lw_solver_2stream(tau, ssa, g, lay_source, lev_source, sfc_emis,
                      sfc_src, inc_flux, *, top_at_1: bool,
                      spectral: bool = False, gpt2band=None,
                      nband: int = 0) -> LWFluxes:
    """True two-stream LW solve (reference rte_lw_solver_2stream,
    :377-440). Broadband output, or per-band sums (ncol, nlay+1, nband)
    with ``gpt2band`` (int32, 0-based band of each g-point) and ``nband``,
    goes through the kernel ``ops/kernels/solver_lw_2str`` (the CUDA
    kernel on a CUDA tensor, its plain twin on a CPU one); ``spectral``
    output is plain tensor code. Differentiable through the twin's
    gradient: the JAX package gives this kernel no VJP
    (ops/solver_lw.py:505-508)."""
    from .kernels.autodiff import with_twin_grad
    from .kernels.solver_lw_2str import lw_2stream, lw_2stream_plain

    if not top_at_1:
        tau, ssa, g, lay_source, lev_source = (
            torch.flip(x, [1]) for x in (tau, ssa, g, lay_source, lev_source))
    if spectral:
        up, dn = two_stream_lw(tau, ssa, g, lev_source, sfc_emis, sfc_src,
                               inc_flux)
    else:
        up, dn = with_twin_grad(
            lambda *a: lw_2stream(*a, nband=nband),
            lambda *a: lw_2stream_plain(*a, nband=nband),
            *(x.contiguous() for x in (tau, ssa, g, lay_source, lev_source,
                                       sfc_emis, sfc_src, inc_flux)),
            gpt2band, name="lw_2stream")
    if not top_at_1:
        up, dn = torch.flip(up, [1]), torch.flip(dn, [1])
    return LWFluxes(flux_up=up, flux_dn=dn, flux_up_jac=None)
