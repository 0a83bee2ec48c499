"""MERRA aerosol optics by band: the CUDA kernel ``csrc/aerosol_props.cu``
and its plain-PyTorch twin.

No TPU kernel corresponds: the JAX package forms these in plain JAX
(``rte_rrtmgp_tpu/models/rrtmgp/aerosol_optics.py::_tau_triplet``;
reference ``compute_aerosol_optics``, rrtmgp/frontend/
mo_aerosol_optics_rrtmgp_merra.F90). Per cell: the size bin, the
relative-humidity pair and weight, the species' rows of the concatenated
(species, rh, bin) table (``AerosolOpticsMERRA.lut``), the RH lerp of
(ext, ssa, g) and (tau, tau*ssa, tau*ssa*g) by band. One launch gives,
by ``mode``:

  * ``LANES``: (tau, tau*ssa, tau*ssa*g), (3, nbnd, nlay, ncol);
  * ``LW``: the absorption tau - tau*ssa plus the clouds' (the LW
    increment of the all-sky step), (nbnd, nlay, ncol);
  * ``SW``: the delta-scaled aerosols combined with the delta-scaled
    clouds (the SW increment), (3, nbnd, nlay, ncol) = (tau, ssa, g).

``cloud`` is the clouds' (tau, tau*ssa, tau*ssa*g) by band, each
(nbnd, nlay, ncol) (``CloudOpticsRRTMGP.cloud_optics_lanes``), or None.
Inputs are (ncol, nlay).

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`aerosol_props_plain`. The kernel has no backward of
its own: on CUDA it refuses inputs that require grad, and
``AerosolOpticsMERRA`` takes the twin's gradient through
``autodiff.with_twin_grad``.
"""
from __future__ import annotations

import torch

from ._build import check_args, launch, on_cpu
from .autodiff import refuse_grad

__all__ = ["aerosol_props", "aerosol_props_plain", "delta_scaled_band",
           "combine_band_2str", "LANES", "LW", "SW"]

LANES, LW, SW = 0, 1, 2
# the species' type codes (reference :43-52) in the order of the offsets
# into the row table
_CODES = (1, 2, 3, 4, 5, 6, 7)

_HINT = "AerosolOpticsMERRA differentiates it through autodiff.with_twin_grad"


def delta_scaled_band(t, ts, tsg):
    """(tau, tau*ssa, tau*ssa*g) by band -> delta-Eddington-scaled
    (tau, ssa, g) with f = g^2 (JAX drivers/allsky.py:131-144)."""
    finfo = torch.finfo(t.dtype)
    g = tsg / torch.clamp(ts, min=finfo.eps)
    ssa = ts / torch.clamp(t, min=finfo.eps)
    f = g * g
    wf = ssa * f
    return ((1.0 - wf) * t,
            torch.where(wf < 1.0, (ssa - wf)
                        / torch.clamp(1.0 - wf, min=finfo.tiny), 0.0),
            torch.where(f < 1.0, (g - f)
                        / torch.clamp(1.0 - f, min=finfo.tiny), 0.0))


def combine_band_2str(a, b):
    """Two by-band (tau, ssa, g) increments as one (JAX drivers/
    allsky.py:147-162): the tau-weighted averaging of
    increment_2stream_by_2stream is associative, so incrementing with the
    combination equals the reference's sequential increments
    (rrtmgp_allsky.F90:394-399). Either may be None."""
    if a is None:
        return b
    if b is None:
        return a
    tiny = torch.finfo(a[0].dtype).tiny
    t = a[0] + b[0]
    tauscat = a[0] * a[1] + b[0] * b[1]
    g = (a[0] * a[1] * a[2] + b[0] * b[1] * b[2]) / torch.clamp(tauscat,
                                                               min=tiny)
    ssa = tauscat / torch.clamp(t, min=tiny)
    return (t, torch.where(t > 2.0 * tiny, ssa, 0.0),
            torch.where(tauscat > 2.0 * tiny, g, 0.0))


def _triplet(atype, size, mass, rh, lut, offsets):
    """(tau, tau*ssa, tau*ssa*g), each (ncol, nlay, nbnd) (JAX
    aerosol_optics.py:180-243)."""
    bin_lims, rh_grid, table = lut
    dtype = size.dtype
    rh_grid = rh_grid.to(dtype)
    nbin, nrh = bin_lims.shape[1], rh_grid.shape[0]
    nbnd = table.shape[2]

    # size bin: the last bin whose [lo, hi] holds the size (ref :472-477)
    ibin = torch.zeros_like(atype)
    for i in range(nbin):
        inbin = (size >= bin_lims[0, i]) & (size <= bin_lims[1, i])
        ibin = torch.where(inbin, i, ibin)

    # RH pair (ref :481-494): irh2 is the first grid point >= rh
    nbelow = (rh[..., None] > rh_grid).sum(-1)
    irh1 = torch.where(nbelow == 0, 0, torch.clamp(nbelow, 1, nrh) - 1)
    irh2 = torch.clamp(nbelow, 0, nrh - 1)
    same = irh1 == irh2
    drh0 = rh_grid[irh2] - rh_grid[irh1]
    drh1 = rh - rh_grid[irh1]
    rdrh = torch.where(same, 0.0, drh1 / torch.where(same, 1.0, drh0))

    dust, salt, sulf, bcar_rh, bcar, ocar_rh, ocar = offsets

    def rows_of(irh):
        r = torch.zeros_like(atype)
        for code, row in zip(_CODES, (dust + ibin, salt + irh * nbin + ibin,
                                      sulf + irh, bcar_rh + irh, bcar,
                                      ocar_rh + irh, ocar)):
            r = torch.where(atype == code, row, r)
        return r.long()

    flat = table.reshape(table.shape[0], 3 * nbnd)
    lo = flat[rows_of(irh1)]                        # (ncol, nlay, 3 * nbnd)
    hi = flat[rows_of(irh2)]
    v = (lo + rdrh[..., None] * (hi - lo)).reshape(
        tuple(atype.shape) + (3, nbnd))
    tau = mass[..., None] * v[..., 0, :]
    taussa = tau * v[..., 1, :]
    return tau, taussa, taussa * v[..., 2, :]


def aerosol_props_plain(atype, size, mass, rh, lut, offsets, cloud=None,
                        mode=LANES):
    """atype (ncol, nlay) int32 type codes; size [microns], mass [kg/m2],
    rh in [0, 1], each (ncol, nlay); ``lut`` = (bin_lims (2, nbin), the RH
    grid (nrh,), the row table (nrows, 3, nbnd)), ``offsets`` the first
    row of dust, salt, sulfate, bcar_rh, bcar, ocar_rh and ocar. Returns
    the ``mode``'s output (see the module's notes)."""
    lane = lambda x: x.permute(2, 1, 0)
    t, ts, tsg = (lane(x) for x in _triplet(atype, size, mass, rh, lut,
                                            offsets))
    if mode == LANES:
        return torch.stack([t, ts, tsg])
    if mode == LW:
        a = t - ts
        return (a if cloud is None else (cloud[0] - cloud[1]) + a) \
            .contiguous()
    aer = delta_scaled_band(t, ts, tsg)
    if cloud is not None:
        aer = combine_band_2str(delta_scaled_band(*cloud), aer)
    return torch.stack(aer)


def aerosol_props(atype, size, mass, rh, lut, offsets, cloud=None,
                  mode=LANES):
    """:func:`aerosol_props_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``aerosol_props.launches``)."""
    if on_cpu(size, "aerosol_props"):
        return aerosol_props_plain(atype, size, mass, rh, lut, offsets,
                                   cloud, mode)
    refuse_grad("aerosol_props", size, mass, rh, lut, cloud, hint=_HINT)
    if mode not in (LANES, LW, SW):
        raise ValueError(f"aerosol_props: unknown mode {mode}")
    ncol, nlay = size.shape
    bin_lims, rh_grid, table = lut
    nbin, nrh, nbnd = bin_lims.shape[1], rh_grid.shape[0], table.shape[2]
    f32 = torch.float32
    field = (ncol, nlay)
    specs = {"atype": (atype, field, torch.int32), "size": (size, field, f32),
             "mass": (mass, field, f32), "rh": (rh, field, f32),
             "bin_lims": (bin_lims, (2, nbin), f32),
             "rh_grid": (rh_grid, (nrh,), f32),
             "table": (table, (table.shape[0], 3, nbnd), f32)}
    if cloud is not None:
        specs.update({f"cloud[{i}]": (c, (nbnd, nlay, ncol), f32)
                      for i, c in enumerate(cloud)})
    check_args("aerosol_props", size.device, specs)
    shape = (nbnd, nlay, ncol) if mode == LW else (3, nbnd, nlay, ncol)
    out = torch.empty(shape, dtype=f32, device=size.device)
    c = (None, None, None) if cloud is None else tuple(cloud)
    launch("aerosol_props", "launch_aerosol_props", "aerosol_props",
           atype, size, mass, rh, bin_lims, rh_grid, table, *c, out, ncol,
           nlay, nbnd, nbin, nrh, *offsets, mode)
    aerosol_props.launches += 1
    return out


aerosol_props.launches = 0
