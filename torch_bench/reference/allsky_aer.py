"""The plain reference of the all-sky problem with MERRA aerosols: LW and
SW fluxes of one state with clouds and aerosols, as the reference's
all-sky example steps it (rrtmgp_allsky.F90:353-404), in column blocks
on the device, in any float dtype (float64 for the check, a lower one for
the control).

The gas, cloud and solver physics are ``reference/rrtmgp.py``'s. The
aerosol lookup is written here from mo_aerosol_optics_rrtmgp_merra.F90
(compute_aerosol_optics: the size bin, the RH pair, the per-species
select case, the RH lerp of each property) in plain tensor code,
evaluating every species on every cell and selecting by type, and reads
only the generator's raw tables (``traffic/allsky_aer.py``). The LW
increment is the clouds' and the aerosols' absorption (1scl by 2str:
tau (1 - ssa)); the SW state is the gas's, incremented by the
delta-scaled clouds, then by the delta-scaled aerosols
(increment_2stream_by_2stream, delta_scale with f = g^2).

Departures, each an equal result in exact arithmetic:

  * the aerosols' (ssa, g) are formed as tau*ssa / tau and
    tau*ssa*g / tau*ssa where those are positive, and 0 elsewhere, where
    the reference divides by max(eps, .); the increments guard their
    divisions by 2 * tiny, as ``reference/rrtmgp.add_clouds_sw``;
  * the program combines the clouds' and the aerosols' increments before
    adding them to the gas; the tau-weighted increment is associative,
    so the order moves only rounding.

TF32 is off for the forward (the step has no matrix product it would
round).
"""
from __future__ import annotations

import torch

from torch_bench.reference import rrtmgp as R

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")
DUST, SALT, SULF, BCAR_RH, BCAR, OCAR_RH, OCAR = range(1, 8)


class Aerosols:
    """MERRA/GOCART optics by band from the raw tables (reference
    load_lut's in-memory order: dust (3, nbin, nbnd), salt
    (nrh, 3, nbin, nbnd), sulfate, bcar_rh, ocar_rh (nrh, 3, nbnd), bcar,
    ocar (3, nbnd))."""

    def __init__(self, raw: dict, dtype, device):
        t = lambda x: R._t(x, dtype, device)
        self.lims = t(raw["merra_aero_bin_lims"])           # (2, nbin)
        self.rh = t(raw["aero_rh"])                          # (nrh,)
        self.dust = t(raw["aero_dust_tbl"])
        self.salt = t(raw["aero_salt_tbl"])
        self.rh_tables = {SULF: t(raw["aero_sulf_tbl"]),
                          BCAR_RH: t(raw["aero_bcar_rh_tbl"]),
                          OCAR_RH: t(raw["aero_ocar_rh_tbl"])}
        self.flat = {BCAR: t(raw["aero_bcar_tbl"]),
                     OCAR: t(raw["aero_ocar_tbl"])}

    def bands(self, atype, size, mass, rh):
        """(tau, tau*ssa, tau*ssa*g), each (ncol, nlay, nbnd)."""
        nbin, nrh = self.lims.shape[1], self.rh.shape[0]
        # the size bin: the last bin whose limits hold the size
        ibin = torch.zeros_like(atype, dtype=torch.long)
        for i in range(nbin):
            ibin = torch.where((size >= self.lims[0, i])
                               & (size <= self.lims[1, i]), i, ibin)
        # irh2 walks up the grid while rh lies above it (at most to the
        # last point); irh1 is the point below it, or the same at the ends
        above = (rh[..., None] > self.rh).sum(-1)
        irh2 = torch.clamp(above, max=nrh - 1)
        irh1 = torch.clamp(above - 1, min=0).clamp(max=nrh - 1)
        w = torch.where(irh1 == irh2, 0.0,
                        (rh - self.rh[irh1])
                        / torch.where(irh1 == irh2, 1.0,
                                      self.rh[irh2] - self.rh[irh1]))
        w = w[..., None]
        lerp = lambda lo, hi: lo + w * (hi - lo)     # each (..., nbnd)
        zero = torch.zeros(tuple(atype.shape) + (self.dust.shape[-1],),
                           dtype=mass.dtype, device=mass.device)
        ext, ssa, g = zero, zero, zero
        cases = {DUST: [self.dust[q][ibin] for q in range(3)],
                 SALT: [lerp(self.salt[irh1, q, ibin], self.salt[irh2, q, ibin])
                        for q in range(3)]}
        for code, tab in self.rh_tables.items():
            cases[code] = [lerp(tab[irh1, q], tab[irh2, q]) for q in range(3)]
        for code, tab in self.flat.items():
            cases[code] = [tab[q].expand_as(zero) for q in range(3)]
        for code, (e, s, a) in cases.items():
            here = (atype == code)[..., None]
            ext = torch.where(here, e, ext)
            ssa = torch.where(here, s, ssa)
            g = torch.where(here, a, g)
        tau = mass[..., None] * ext
        taussa = tau * ssa
        return tau, taussa, taussa * g


def _delta_scaled(tau, taussa, taussag):
    """(tau, ssa, g) delta-scaled with f = g^2 (delta_scale_2str_f_k)."""
    tiny = torch.finfo(tau.dtype).tiny
    ssa = torch.where(tau > 0.0, taussa / torch.clamp(tau, min=tiny), 0.0)
    g = torch.where(taussa > 0.0, taussag / torch.clamp(taussa, min=tiny),
                    0.0)
    f = g * g
    wf = ssa * f
    return ((1.0 - wf) * tau,
            torch.where(wf < 1.0, (ssa - wf)
                        / torch.clamp(1.0 - wf, min=tiny), 0.0),
            torch.where(f < 1.0, (g - f) / torch.clamp(1.0 - f, min=tiny),
                        0.0))


def _increment(a, b):
    """(tau, ssa, g) ``b`` added to ``a`` (increment_2stream_by_2stream)."""
    tiny = torch.finfo(a[0].dtype).tiny
    tau = a[0] + b[0]
    scat = a[0] * a[1] + b[0] * b[1]
    g = torch.where(scat > 2.0 * tiny, (a[0] * a[1] * a[2]
                                        + b[0] * b[1] * b[2])
                    / torch.clamp(scat, min=tiny), 0.0)
    ssa = torch.where(tau > 2.0 * tiny, scat / torch.clamp(tau, min=tiny),
                      a[1])
    return tau, ssa, g


class AllSkyAer:
    def __init__(self, data: dict, dtype, device):
        self.dtype, self.device = dtype, device
        self.lw = R.KTables(data["lw"], dtype, device)
        self.sw = R.KTables(data["sw"], dtype, device)
        self.cld_lw = R.Clouds(data["cloud_lw"], dtype, device)
        self.cld_sw = R.Clouds(data["cloud_sw"], dtype, device)
        self.aer_lw = Aerosols(data["aerosol_lw"], dtype, device)
        self.aer_sw = Aerosols(data["aerosol_sw"], dtype, device)

    def inputs(self, state: dict, cols: slice) -> dict:
        """The state's columns ``cols`` in the reference's dtype; the
        generator's float32 values are the program's inputs exactly."""
        c = lambda x: x.to(device=self.device, dtype=self.dtype)
        x = {k: c(state[k][cols]) for k in (
            "play", "plev", "tlay", "tlev", "tsfc", "h2o", "lwp", "iwp",
            "rel", "dei", "mu0", "sfc_emis", "sfc_alb", "aero_size",
            "aero_mass", "relhum")}
        x["aero_type"] = state["aero_type"][cols].to(self.device)
        x["vmr"] = dict(h2o=x.pop("h2o"), o3=c(state["o3"]), **{
            g: c(torch.tensor(v, dtype=torch.float32))
            for g, v in state["gases"].items()})
        return x

    def fluxes(self, x: dict):
        """(lw_up, lw_dn, sw_up, sw_dn, sw_dir), each (ncol, nlay+1)."""
        aer = (x["aero_type"], x["aero_size"], x["aero_mass"], x["relhum"])
        tau, (lay, lev, sfc) = R.gas_lw(self.lw, x["play"], x["plev"],
                                        x["tlay"], x["tlev"], x["tsfc"],
                                        x["vmr"])
        c = self.cld_lw.bands(x["lwp"], x["iwp"], x["rel"], x["dei"])
        a = self.aer_lw.bands(*aer)
        band = self.lw.gpt2band
        tau = tau + (c[0] - c[1])[..., band] + (a[0] - a[1])[..., band]
        lw_up, lw_dn = R.lw_solve(tau, lay, lev, sfc, x["sfc_emis"])
        tau, ssa = R.gas_sw(self.sw, x["play"], x["plev"], x["tlay"],
                            x["vmr"])
        band = self.sw.gpt2band
        c = self.cld_sw.bands(x["lwp"], x["iwp"], x["rel"], x["dei"])
        gas_cloud = R.add_clouds_sw(tau, ssa, c, band)
        a = _delta_scaled(*(v[..., band] for v in self.aer_sw.bands(*aer)))
        tau, ssa, g = _increment(gas_cloud, a)
        inc = self.sw.solar[None].expand(tau.shape[0], -1)
        sw_up, sw_dn, sw_dir = R.sw_solve(tau, ssa, g, x["mu0"],
                                          x["sfc_alb"], inc)
        return lw_up, lw_dn, sw_up, sw_dn, sw_dir


def forward(data: dict, state: dict, dtype=torch.float64, device=None,
            block: int = 512):
    """The five fluxes of ``state``, float64, (ncol, nlay+1) each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = AllSkyAer(data, dtype, device or state["play"].device)
    n = state["play"].shape[0]
    out = [ref.fluxes(ref.inputs(state, slice(i, min(i + block, n))))
           for i in range(0, n, block)]
    return tuple(torch.cat([o[i] for o in out]).double()
                 for i in range(len(OUTPUTS)))


def increments(data: dict, state: dict, dtype=torch.float64, device=None,
               block: int = 512):
    """The clouds' and the aerosols' increments by band of ``state``, as
    the program folds them before adding them to the gas (the second
    departure above): the LW absorption (tau - tau*ssa of both, summed),
    and the SW delta-scaled clouds incremented by the delta-scaled
    aerosols (tau, ssa, g); each (ncol, nlay, nbnd), float64."""
    dev = device or state["play"].device
    cld = [R.Clouds(data[k], dtype, dev) for k in ("cloud_lw", "cloud_sw")]
    aer = [Aerosols(data[k], dtype, dev) for k in ("aerosol_lw",
                                                   "aerosol_sw")]
    n = state["play"].shape[0]
    out = []
    for i in range(0, n, block):
        cols = slice(i, min(i + block, n))
        x = {k: state[k][cols].to(device=dev, dtype=dtype) for k in (
            "lwp", "iwp", "rel", "dei", "aero_size", "aero_mass", "relhum")}
        t = state["aero_type"][cols].to(dev)
        bands = lambda c, a: (
            c.bands(x["lwp"], x["iwp"], x["rel"], x["dei"]),
            a.bands(t, x["aero_size"], x["aero_mass"], x["relhum"]))
        c, a = bands(cld[0], aer[0])
        lw = (c[0] - c[1]) + (a[0] - a[1])
        c, a = bands(cld[1], aer[1])
        sw = _increment(_delta_scaled(*c), _delta_scaled(*a))
        out.append((lw,) + tuple(sw))
    return tuple(torch.cat([o[j] for o in out]).double() for j in range(4))
