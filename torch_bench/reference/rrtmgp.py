"""A plain PyTorch RTE+RRTMGP: the yardstick that decides ``correct``.

Written from the reference's equations (rrtmgp/kernels/
mo_gas_optics_rrtmgp_kernels.F90, rte/kernels/mo_rte_solver_kernels.F90,
mo_cloud_optics_rrtmgp_kernels.F90) in plain tensor code, in any float
dtype (float64 for the reference, a lower one for the control). It
imports nothing of the program and reads only the generator's raw arrays
(``traffic/generator.py``), never a table the program has made.

Fields are (ncol, nlay[+1]) with the top at layer 0; spectral fields
(ncol, nlay, ngpt). Column blocks are independent, so callers run it in
blocks to bound memory.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
AVOGAD = 6.02214076e23
GRAV = 9.80665
M_DRY = 0.028964
M_H2O = 0.018016
# one-angle LW: the Gauss-Jacobi-5 secant of the one-point rule
LW_DS = 1.0 / 0.6096748751
LW_WEIGHT = 1.0
_A_OFFSET, _B_OFFSET = 0.1495954, 0.00066696


def _t(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                           device=device)


class KTables:
    """One k-distribution in the reference's own terms: col_gas index
    0 is dry air, gas i of ``gas_names`` is index i + 1."""

    def __init__(self, raw: dict, dtype, device):
        gases = [g.lower() for g in raw["gas_names"]]
        self.gases = gases
        ks = np.asarray(raw["key_species"])
        nbnd = ks.shape[2]
        lims = np.asarray(raw["band_lims_gpt"])
        self.gpt2band = np.concatenate([np.full(b1 - b0 + 1, b)
                                        for b, (b0, b1) in enumerate(lims)])
        ngpt = len(self.gpt2band)
        pair = lambda a, b: ((2, 2) if tuple(ks[:, a, b]) == (0, 0)
                             else tuple(int(v) for v in ks[:, a, b]))
        flav = sorted({pair(a, b) for b in range(nbnd) for a in range(2)})
        self.flavor = np.asarray(flav).T                    # (2, nflav)
        self.gflav = np.array([[flav.index(pair(a, self.gpt2band[g]))
                                for g in range(ngpt)] for a in range(2)])
        t = lambda x: _t(x, dtype, device)
        self.kmajor = t(raw["kmajor"])
        self.ntemp, self.neta, self.npres1, self.ngpt = self.kmajor.shape
        temp_ref = np.asarray(raw["temp_ref"], np.float64)
        press_ref = np.asarray(raw["press_ref"], np.float64)
        self.temp_ref = temp_ref
        self.tmin, self.tmax = float(temp_ref[0]), float(temp_ref[-1])
        self.tdelta = (self.tmax - self.tmin) / (len(temp_ref) - 1)
        self.plog0 = float(np.log(press_ref[0]))
        self.npres = len(press_ref)
        self.plog_delta = float((np.log(press_ref[-1]) - self.plog0)
                                / (self.npres - 1))
        self.p_trop = float(raw["press_ref_trop"])
        self.vmr_ref = np.asarray(raw["vmr_ref"], np.float64)
        ident = [s.lower() for s in raw["identifier_minor"]]
        gmin = [s.lower() for s in raw["gas_minor"]]
        self.minors = []
        for atm, sfx in ((0, "lower"), (1, "upper")):
            names = raw[f"minor_gases_{sfx}"]
            for i, name in enumerate(names):
                g0, g1 = (int(v) - 1 for v in raw[f"minor_limits_gpt_{sfx}"][i])
                sg = raw[f"scaling_gas_{sfx}"][i].lower()
                self.minors.append(dict(
                    atm=atm, g0=g0, w=g1 - g0 + 1,
                    gas=gases.index(gmin[ident.index(name.lower())]) + 1,
                    density=bool(raw[f"minor_scales_with_density_{sfx}"][i]),
                    scaling=gases.index(sg) + 1 if sg else -1,
                    complement=bool(raw[f"scale_by_complement_{sfx}"][i]),
                    start=int(raw[f"kminor_start_{sfx}"][i]) - 1,
                    flavor=int(self.gflav[atm, g0])))
        self.kminor = (t(raw["kminor_lower"]), t(raw["kminor_upper"]))
        self.krayl = (torch.stack([t(raw["rayl_lower"]), t(raw["rayl_upper"])],
                                  dim=-1) if "rayl_lower" in raw else None)
        self.pfrac = t(raw["planck_frac"]) if "planck_frac" in raw else None
        self.totplnk = t(raw["totplnk"]) if "totplnk" in raw else None
        if self.totplnk is not None:
            self.tp_delta = (self.tmax - self.tmin) / (self.totplnk.shape[0] - 1)
        self.solar = None
        if "solar_quiet" in raw:
            src = (t(raw["solar_quiet"])
                   + (raw["mg_default"] - _A_OFFSET) * t(raw["solar_facular"])
                   + (raw["sb_default"] - _B_OFFSET) * t(raw["solar_sunspot"]))
            self.solar = src * (raw["tsi_default"] / src.sum())
        self.idx_h2o = gases.index("h2o") + 1

    # ---------------------------------------------------------------
    def col_gas(self, plev, vmr: dict):
        """(ngas+1, ncol, nlay) molecules/cm2, dry air at 0 (reference
        get_layer_number and compute_gas_taus)."""
        h2o = vmr["h2o"]
        dp = (plev[:, :-1] - plev[:, 1:]).abs()
        fact = 1.0 / (1.0 + h2o)
        m_air = (M_DRY + M_H2O * h2o) * fact
        col_dry = 10.0 * dp * AVOGAD * fact / (1000.0 * m_air * 100.0 * GRAV)
        rows = [col_dry] + [vmr[g] * col_dry for g in self.gases]
        return torch.stack([r.expand_as(col_dry) for r in rows])

    def interp(self, play, tlay, cg):
        """Temperature, pressure and per-flavor eta coordinates (reference
        rrtmgp_interpolation)."""
        dt = play.dtype
        loct = (tlay - (self.tmin - self.tdelta)) / self.tdelta
        jt1 = torch.clamp(torch.floor(loct), 1, self.ntemp - 1)
        temp_ref = torch.as_tensor(self.temp_ref, dtype=dt,
                                   device=play.device)
        ftemp = (tlay - temp_ref[jt1.long() - 1]) / self.tdelta
        jtemp = jt1.long() - 1
        locp = 1.0 + (torch.log(play) - self.plog0) / self.plog_delta
        jp = torch.clamp(torch.trunc(locp), 1.0, float(self.npres - 1))
        fpress = locp - jp
        tropo = play > self.p_trop
        g1, g2 = self.flavor
        ratio = torch.as_tensor(self.vmr_ref[:, g1, :] / self.vmr_ref[:, g2, :],
                                dtype=dt, device=play.device)
        jeta, feta, cmix = [], [], []
        for it in (0, 1):
            jti = torch.clamp(jtemp + it, 0, self.ntemp - 1)
            r = torch.where(tropo, ratio[0][:, jti], ratio[1][:, jti])
            cm = cg[g1] + r * cg[g2]
            big = cm > 2.0 * torch.finfo(dt).tiny
            eta = torch.where(big, cg[g1] / torch.where(big, cm, 1.0), 0.5)
            loc = eta * (self.neta - 1)
            tr = torch.trunc(loc)
            jeta.append(torch.clamp(tr.long() + 1, max=self.neta - 1) - 1)
            feta.append(loc - tr)
            cmix.append(cm)
        return dict(jtemp=jtemp, ftemp=ftemp, jpress=jp.long() - 1,
                    fpress=fpress, tropo=tropo, jeta=jeta, feta=feta,
                    cmix=cmix)

    def _per_gpt(self, co, x):
        """(nflav, ncol, nlay) -> (ncol, nlay, ngpt): each g-point's flavor
        in the cell's atmosphere."""
        dev = co["tropo"].device
        lo = x[torch.as_tensor(self.gflav[0], device=dev)].permute(1, 2, 0)
        up = x[torch.as_tensor(self.gflav[1], device=dev)].permute(1, 2, 0)
        return torch.where(co["tropo"][..., None], lo, up)

    def major(self, co, planck: bool):
        """Major-gas tau and, with ``planck``, the Planck fraction, from
        the 8 corners (reference gas_optical_depths_major,
        interpolate3D_byflav)."""
        je = [self._per_gpt(co, co["jeta"][i]) for i in (0, 1)]
        fe = [self._per_gpt(co, co["feta"][i]) for i in (0, 1)]
        cm = [self._per_gpt(co, co["cmix"][i]) for i in (0, 1)]
        ft = (1.0 - co["ftemp"][..., None], co["ftemp"][..., None])
        fp = (1.0 - co["fpress"][..., None], co["fpress"][..., None])
        jt = co["jtemp"][..., None]
        jp = (co["jpress"] + torch.where(co["tropo"], 0, 1))[..., None]
        g = torch.arange(self.ngpt, device=jt.device)
        kflat = self.kmajor.reshape(-1)
        pflat = self.pfrac.reshape(-1) if planck else None
        tau = pf = 0.0
        for it in (0, 1):
            for de in (0, 1):
                w_e = fe[it] if de else 1.0 - fe[it]
                for dp in (0, 1):
                    wgt = w_e * ft[it] * fp[dp]
                    flat = ((((jt + it) * self.neta + je[it] + de)
                             * self.npres1 + jp + dp) * self.ngpt + g)
                    tau = tau + wgt * cm[it] * kflat[flat]
                    if planck:
                        pf = pf + wgt * pflat[flat]
        return tau, (pf if planck else None)

    def minor_taus(self, co, cg, play, tlay, tau):
        """tau plus every minor gas over its g-point window, in its
        atmosphere (reference gas_optical_depths_minor)."""
        col_dry = cg[0]
        dry_fact = 1.0 / (1.0 + cg[self.idx_h2o] / col_dry)
        ft = (1.0 - co["ftemp"], co["ftemp"])
        for m in self.minors:
            s = cg[m["gas"]]
            if m["density"]:
                s = s * (0.01 * play / tlay)
                if m["scaling"] > 0:
                    frac = cg[m["scaling"]] / col_dry * dry_fact
                    s = s * ((1.0 - frac) if m["complement"] else frac)
            inside = co["tropo"] if m["atm"] == 0 else ~co["tropo"]
            s = torch.where(inside, s, 0.0)
            tab = self.kminor[m["atm"]]
            win = tab.reshape(self.ntemp * self.neta, -1)[
                :, m["start"]:m["start"] + m["w"]]
            k = 0.0
            for it in (0, 1):
                row = (co["jtemp"] + it) * self.neta + co["jeta"][it][m["flavor"]]
                f = co["feta"][it][m["flavor"]][..., None]
                k = k + ((1.0 - f) * win[row] + f * win[row + 1]) \
                    * ft[it][..., None]
            window = torch.arange(m["g0"], m["g0"] + m["w"], device=tau.device)
            tau = tau.index_add(-1, window, s[..., None] * k)
        return tau

    def rayleigh(self, co, cg):
        """Rayleigh tau (reference compute_tau_rayleigh)."""
        je = [self._per_gpt(co, co["jeta"][i]) for i in (0, 1)]
        fe = [self._per_gpt(co, co["feta"][i]) for i in (0, 1)]
        jt = co["jtemp"][..., None]
        atm = torch.where(co["tropo"], 0, 1)[..., None]
        g = torch.arange(self.ngpt, device=jt.device)
        kflat = self.krayl.reshape(-1)
        k = 0.0
        for it in (0, 1):
            ft = co["ftemp"][..., None] if it else 1.0 - co["ftemp"][..., None]
            for de in (0, 1):
                w = fe[it] if de else 1.0 - fe[it]
                flat = (((jt + it) * self.neta + je[it] + de) * self.ngpt
                        + g) * 2 + atm
                k = k + w * ft * kflat[flat]
        return k * (cg[self.idx_h2o] + cg[0])[..., None]

    def planck(self, pfrac, tlay, tlev, tsfc):
        """Layer, level and surface sources (reference
        compute_Planck_source): the band's totplnk lerp times the Planck
        fraction, geometric means of the fractions at the levels."""
        band = torch.as_tensor(self.gpt2band, device=pfrac.device)

        def pb(t):
            v = (t - self.tmin) / self.tp_delta
            frac = v - torch.trunc(v)
            i = torch.clamp(torch.trunc(v).long(), 0,
                            self.totplnk.shape[0] - 2)
            lo, hi = self.totplnk[i], self.totplnk[i + 1]
            return (lo + frac[..., None] * (hi - lo))[..., band]

        pp = pfrac[:, 1:] * pfrac[:, :-1]
        inner = torch.where(pp > 0.0, torch.sqrt(torch.where(pp > 0.0, pp,
                                                             1.0)), 0.0)
        lev_pf = torch.cat([pfrac[:, :1], inner, pfrac[:, -1:]], dim=1)
        return pfrac * pb(tlay), lev_pf * pb(tlev), pfrac[:, -1] * pb(tsfc)


def lw_solve(tau, lay, lev, sfc, emis):
    """One-angle no-scattering LW transport with the linear-in-tau
    source (reference lw_solver_noscat, lw_source_noscat), no incident
    flux: broadband (up, dn), each (ncol, nlay+1), in W/m2."""
    eps = torch.finfo(tau.dtype).eps
    tl = tau * LW_DS
    trans = torch.exp(-tl)
    fact = torch.where(tl > math.sqrt(math.sqrt(eps)),
                       (1.0 - trans) / torch.clamp(tl, min=torch.finfo(
                           tau.dtype).tiny) - trans,
                       tl * (0.5 + tl * (-1.0 / 3.0 + tl / 8.0)))
    top, bot = lev[:, :-1], lev[:, 1:]
    s_dn = (1.0 - trans) * bot + 2.0 * fact * (lay - bot)
    s_up = (1.0 - trans) * top + 2.0 * fact * (lay - top)
    nlay = tau.shape[1]
    dn = [torch.zeros_like(sfc)]
    for k in range(nlay):
        dn.append(trans[:, k] * dn[-1] + s_dn[:, k])
    up = [dn[-1] * (1.0 - emis) + emis * sfc]
    for k in range(nlay - 1, -1, -1):
        up.append(trans[:, k] * up[-1] + s_up[:, k])
    up.reverse()
    w = PI * LW_WEIGHT
    return (w * torch.stack(up, dim=1).sum(-1),
            w * torch.stack(dn, dim=1).sum(-1))


def sw_solve(tau, ssa, g, mu0, alb, inc):
    """Two-stream SW (Meador-Weaver with the Zdunkowski PIFM gammas, the
    energy clamps) and adding (Shonk and Hogan 2008); mu0 (ncol,), alb
    (ncol, 1), inc (ncol, ngpt). Broadband (up, dn total, dir)."""
    dt = tau.dtype
    eps = torch.finfo(dt).eps
    mu = mu0[:, None, None]
    g1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    g2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    k = torch.sqrt(torch.clamp((g1 - g2) * (g1 + g2), min=1.0e4 * eps))
    e1 = torch.exp(-tau * k)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + g1 * (1.0 - e2))
    rdif = rt * g2 * (1.0 - e2)
    tdif = rt * 2.0 * k * e1
    mus = torch.clamp(mu, min=math.sqrt(eps))
    kmu = k * mus
    den = 1.0 - kmu * kmu
    den = torch.where(den.abs() >= eps, den, eps)
    rt2 = ssa * rt / den
    g3 = (2.0 - 3.0 * mus * g) * 0.25
    g4 = 1.0 - g3
    a1 = g1 * g4 + g2 * g3
    a2 = g1 * g3 + g2 * g4
    tnos = torch.exp(-tau / mus)
    rdir = rt2 * ((1.0 - kmu) * (a2 + k * g3) - (1.0 + kmu) * (a2 - k * g3) * e2
                  - 2.0 * (k * g3 - a2 * kmu) * e1 * tnos)
    tdir = -rt2 * ((1.0 + kmu) * (a1 + k * g4) * tnos
                   - (1.0 - kmu) * (a1 - k * g4) * e2 * tnos
                   - 2.0 * (k * g4 + a1 * kmu) * e1)
    rdir = torch.minimum(torch.clamp(rdir, min=0.0), 1.0 - tnos)
    tdir = torch.minimum(torch.clamp(tdir, min=0.0), 1.0 - tnos - rdir)
    top = (inc * mu0[:, None])[:, None]
    fdir = top * torch.cat([torch.ones_like(top), torch.cumprod(tnos, 1)], 1)
    s_up = rdir * fdir[:, :-1]
    s_dn = tdir * fdir[:, :-1]
    nlay = tau.shape[1]
    a = [None] * (nlay + 1)
    s = [None] * (nlay + 1)
    den = [None] * nlay
    a[nlay] = alb.expand_as(inc)
    s[nlay] = fdir[:, -1] * alb
    for v in range(nlay - 1, -1, -1):
        r, t = rdif[:, v], tdif[:, v]
        den[v] = 1.0 / (1.0 - r * a[v + 1])
        a[v] = r + t * t * a[v + 1] * den[v]
        s[v] = s_up[:, v] + t * den[v] * (s[v + 1] + a[v + 1] * s_dn[:, v])
    dn = [torch.zeros_like(inc)]
    up = [s[0]]
    for v in range(nlay):
        f = (tdif[:, v] * dn[-1] + rdif[:, v] * s[v + 1] + s_dn[:, v]) * den[v]
        dn.append(f)
        up.append(f * a[v + 1] + s[v + 1])
    up = torch.stack(up, 1).sum(-1)
    dn = torch.stack(dn, 1).sum(-1)
    fdir = fdir.sum(-1)
    return up, dn + fdir, fdir


class Clouds:
    """Cloud optics by band from the liquid and ice size tables (reference
    compute_cld_from_table), the ice at the first roughness."""

    def __init__(self, raw: dict, dtype, device):
        t = lambda x: _t(x, dtype, device)
        self.liq = torch.stack([t(raw["extliq"]), t(raw["ssaliq"]),
                                t(raw["asyliq"])])             # (3, n, nbnd)
        self.ice = torch.stack([t(raw["extice"])[..., 0],
                                t(raw["ssaice"])[..., 0],
                                t(raw["asyice"])[..., 0]])
        self.lims = [(float(raw["radliq_lwr"]), float(raw["radliq_upr"])),
                     (float(raw["diamice_lwr"]), float(raw["diamice_upr"]))]

    def bands(self, lwp, iwp, rel, dei):
        """(tau, tau*ssa, tau*ssa*g), each (ncol, nlay, nbnd)."""
        out = 0.0
        for tab, wp, re, (lo, hi) in ((self.liq, lwp, rel, self.lims[0]),
                                      (self.ice, iwp, dei, self.lims[1])):
            n = tab.shape[1]
            pos = (re - lo) / ((hi - lo) / (n - 1))
            i = torch.clamp(torch.floor(pos), 0, n - 2)
            f = (pos - i)[..., None]
            i = i.long()
            v = tab[:, i] + f * (tab[:, i + 1] - tab[:, i])
            tau = torch.where(wp > 0.0, wp, 0.0)[..., None] * v[0]
            ts = tau * v[1]
            out = out + torch.stack([tau, ts, ts * v[2]])
        return out


def gas_lw(kd: KTables, play, plev, tlay, tlev, tsfc, vmr):
    cg = kd.col_gas(plev, vmr)
    co = kd.interp(play, tlay, cg)
    tau, pfrac = kd.major(co, planck=True)
    tau = kd.minor_taus(co, cg, play, tlay, tau)
    return tau, kd.planck(pfrac, tlay, tlev, tsfc)


def gas_sw(kd: KTables, play, plev, tlay, vmr):
    """Absorption plus Rayleigh: (tau, ssa) with g = 0."""
    cg = kd.col_gas(plev, vmr)
    co = kd.interp(play, tlay, cg)
    tau, _ = kd.major(co, planck=False)
    tau = kd.minor_taus(co, cg, play, tlay, tau)
    ray = kd.rayleigh(co, cg)
    t = tau + ray
    tiny = torch.finfo(t.dtype).tiny
    return t, torch.where(t > 2.0 * tiny, ray / torch.clamp(t, min=tiny), 0.0)


def add_clouds_sw(tau, ssa, cloud, band):
    """Gas (tau, ssa, g = 0) incremented by the delta-scaled (f = g^2)
    cloud of each g-point's band (reference delta_scale and
    increment_2stream_by_2stream)."""
    tiny = torch.finfo(tau.dtype).tiny
    ct, cts, ctsg = (c[..., band] for c in cloud)
    cg = torch.where(cts > 0.0, ctsg / torch.clamp(cts, min=tiny), 0.0)
    cw = torch.where(ct > 0.0, cts / torch.clamp(ct, min=tiny), 0.0)
    f = cg * cg
    ct = (1.0 - cw * f) * ct
    cw = torch.where(cw * f < 1.0, (cw - cw * f)
                     / torch.clamp(1.0 - cw * f, min=tiny), 0.0)
    cg = torch.where(f < 1.0, (cg - f) / torch.clamp(1.0 - f, min=tiny), 0.0)
    t = tau + ct
    scat = tau * ssa + ct * cw
    g = torch.where(scat > 2.0 * tiny, ct * cw * cg
                    / torch.clamp(scat, min=tiny), 0.0)
    return t, torch.where(t > 2.0 * tiny, scat / torch.clamp(t, min=tiny),
                          ssa), g
