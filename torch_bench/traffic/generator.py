"""The benchmark's generator: tables and an input pool from a seed.

Everything a cell feeds the program is made here and in its problem's
file, on the device, from ``--seed`` and the cell's traffic parameters
(``workloads/<cell>.json``, key ``traffic``), in a fixed order: the LW
and SW k-distribution tables and the cloud tables at the configuration's
shapes (this file), the problem's own tables, then a pool of distinct
states that the closed loop cycles through, one per step. The program
receives only these tensors (as numpy arrays where its constructors take
host arrays).

A problem is the configuration's ``problem`` key; its inputs live in
``traffic/<problem>.py``, found by name as the harness finds entries and
references, so a configuration that needs other tables or state fields
brings a file of its own and edits nothing here. The file provides

  state(config, traffic, draw) -> dict   one pool state (required)
  tables(config, data, draw) -> dict     extra tables (optional), drawn
                                         after the shared ones, which
                                         ``data`` holds
  shapes(config) -> dict                 extra sizes for ``work/`` counts
                                         (optional)

The tables take the published files' dimensions from the
configuration: the 19 absorbers, the 21 minor absorbers, the lower and
upper minor windows (each one band wide), the cloud tables' sizes. The
key species, which gas each minor window holds, the reference profiles
and the profile arithmetic are copies of the port's
``utils/synthetic.synthetic_kdist_raw``, ``utils/profiles`` and
``drivers/rfmip.synthetic_rfmip``; the table values, the perturbations
and the cloud and sun draws are the benchmark's own, drawn with one
``torch.Generator`` on the device in a fixed order, so one seed gives one
problem on any run. Every seed gives the same shapes and the same
amount of work: only values move.
"""
from __future__ import annotations

import numpy as np
import torch

from torch_bench import harness

# the absorbers of the published k-distributions (rrtmgp-gas-lw-g256.nc
# and rrtmgp-gas-sw-g224.nc: 19 each) and their present-day volume mixing
# ratios, the tables' reference values and the states' well-mixed values
GASES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2", "ccl4",
         "cfc11", "cfc12", "cfc22", "hfc143a", "hfc125", "hfc23", "hfc32",
         "hfc134a", "cf4", "no2")
VMR = dict(h2o=7.6e-3, co2=3.6e-4, o3=3.2e-6, n2o=3.2e-7, co=1.5e-7,
           ch4=1.7e-6, o2=0.209, n2=0.781, ccl4=8.6e-11, cfc11=2.3e-10,
           cfc12=5.2e-10, cfc22=2.3e-10, hfc143a=1.6e-11, hfc125=1.5e-11,
           hfc23=2.7e-11, hfc32=1.0e-11, hfc134a=8.0e-11, cf4=8.0e-11,
           no2=1.0e-9)
# the well-mixed gases past the example's eight, as every state holds them
TRACE = GASES[8:]
# key species pairs by band (1-based into GASES), as the port's synthetic
# k-distribution lays them out
PAIR_POOL = ((1, 2), (1, 3), (2, 3), (1, 4), (1, 6), (2, 2), (0, 0), (1, 1))
# the 21 minor absorbers the published files count: (identifier, gas,
# scales with density, scaling gas, by complement)
MINORS = (("n2o", "n2o", True, "", False),
          ("h2o_slf", "h2o", True, "h2o", False),
          ("h2o_frg", "h2o", True, "h2o", True),
          ("ch4", "ch4", False, "", False),
          ("co", "co", True, "", False),
          ("o3", "o3", False, "", False),
          ("co2", "co2", True, "", False),
          ("o2", "o2", True, "", False),
          ("n2", "n2", True, "", False),
          ("n2_frg", "n2", True, "h2o", True),
          *((g, g, True, "", False) for g in TRACE))

# RCEMIP / all-sky profile constants (the reference's
# tests/mo_rcemip_profiles.F90:32-49)
_G, _RD, _P0, _QT = 9.79764, 287.04, 101480.0, 1.0e-14
_ZQ1, _ZQ2, _ZT, _GAMMA = 4000.0, 7500.0, 15000.0, 0.0067
_Q0 = 0.012
_G1, _G2, _G3 = 3.6478, 0.83209, 11.3515
_M_AIR, _M_H2O = 0.028964, 0.018016


def _profile(p, sst):
    """T, q (vmr) at pressures p [Pa] of the RCE atmosphere over ``sst``
    (the all-sky example's compute_profiles, the RCEMIP zt_given_p)."""
    tv0 = sst * (1 + 0.608 * _Q0)
    tvt = tv0 - _GAMMA * _ZT
    pt = _P0 * (tvt / tv0) ** (_G / (_RD * _GAMMA))
    tropo = p > pt
    z = np.where(tropo, (tv0 / _GAMMA) * (1 - (p / _P0) ** ((_RD * _GAMMA) / _G)),
                 _ZT + (_RD * tvt / _G) * np.log(np.maximum(pt / p, 1e-300)))
    q = np.where(tropo, _Q0 * np.exp(-z / _ZQ1) * np.exp(-((z / _ZQ2) ** 2)),
                 _QT)
    tv = np.where(tropo, tv0 - _GAMMA * z, tvt)
    return tv / (1 + 0.608 * q), q * _M_AIR / _M_H2O


def column(nlay: int, sst: float):
    """One column, top first: play, plev, tlay, tlev, h2o, o3 (float64
    numpy), equal pressure steps from 1 Pa to the surface."""
    plev = 1.0 + (_P0 - 1.0) / nlay * np.arange(nlay + 1)
    play = 0.5 * (plev[:-1] + plev[1:])
    tlay, q = _profile(play, sst)
    tlev, _ = _profile(plev, sst)
    o3 = _G1 * (play / 100.0) ** _G2 * np.exp(-play / (100.0 * _G3)) * 1.0e-6
    return play, plev, tlay, tlev, q, o3


def flavors(nbnd: int):
    """The k-distribution's key species (2, 2, nbnd), 1-based, and its
    number of flavors: distinct (lower, upper) pairs, (0, 0) read as (2, 2)
    (the reference's flavor rewrite)."""
    ks = np.zeros((2, 2, nbnd), np.int64)
    for b in range(nbnd):
        ks[:, 0, b] = PAIR_POOL[b % len(PAIR_POOL)]
        ks[:, 1, b] = PAIR_POOL[(b + 3) % len(PAIR_POOL)]
    pairs = {(2, 2) if tuple(ks[:, a, b]) == (0, 0) else tuple(ks[:, a, b])
             for b in range(nbnd) for a in range(2)}
    return ks, len(pairs)


def minors(n: int, nbnd: int, width: int):
    """n minor windows, each one band of ``width`` g-points wide (window
    i on band i mod nbnd, absorber i mod 21): identifiers, 1-based
    limits, density flags, scaling gases, complement flags, 1-based
    kminor starts and the contributions' total."""
    names, lims, swd, sgas, sbc, starts = [], [], [], [], [], []
    for i in range(n):
        nm, _, d, sg, cb = MINORS[i % len(MINORS)]
        g0 = (i % nbnd) * width + 1
        names.append(nm)
        lims.append((g0, g0 + width - 1))
        swd.append(d)
        sgas.append(sg)
        sbc.append(cb)
        starts.append(i * width + 1)
    return names, np.asarray(lims), np.asarray(swd), sgas, np.asarray(sbc), \
        np.asarray(starts), n * width


def shapes(config: dict) -> dict:
    """The sizes the work counts read (``work/*.py``): cells, g-points,
    bands, table sizes, flavors and the minor windows' widths, and the
    problem's own sizes where its file has ``shapes``."""
    ncol = config.get("ncol") or config["nsite"] * config["nexp"]
    out = dict(ncol=ncol, nlay=config["nlay"], ntemp=config["ntemp"],
               neta=config["neta"], npres=config["npres"], nplanck=config["ntemp_planck"],
               clouds="cloud_nsize_liq" in config)
    for side in ("lw", "sw"):
        kd = config[f"kdist_{side}"]
        ngpt, nbnd = kd["ngpt"], kd["nbnd"]
        width = ngpt // nbnd
        out[f"ngpt_{side}"], out[f"nbnd_{side}"] = ngpt, nbnd
        out[f"nflav_{side}"] = flavors(nbnd)[1]
        out[f"minor_widths_{side}_lower"] = [width] * kd["nminor_lower"]
        out[f"minor_widths_{side}_upper"] = [width] * kd["nminor_upper"]
    # chip_smoke.shapes passes the sizes of a configuration with no problem
    mod = harness.load("traffic", config["problem"]) \
        if "problem" in config else None
    if hasattr(mod, "shapes"):
        out.update(mod.shapes(config))
    return out


class Draw:
    """Uniform draws on the device from one seeded generator, in the
    dtype the program serves (float32)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return lo + (hi - lo) * u

    def perm(self, n):
        return torch.randperm(n, generator=self.gen, device=self.device)


def kdist_raw(config: dict, sw: bool, draw: Draw) -> dict:
    """KDist.from_raw's keyword arrays: the structure of the port's
    synthetic k-distribution, its tables drawn on the device. Tables are
    tensors; call :func:`host` before handing them to the program."""
    kd = config["kdist_sw" if sw else "kdist_lw"]
    if (kd["nabsorber"], kd["nminor_absorber"]) != (len(GASES), len(MINORS)):
        raise ValueError(f"{kd['file']}: the generator lays out "
                         f"{len(GASES)} absorbers and {len(MINORS)} minor ones")
    ngpt, nbnd = kd["ngpt"], kd["nbnd"]
    ntemp, npres, neta = config["ntemp"], config["npres"], config["neta"]
    width = ngpt // nbnd
    temp_ref = np.linspace(160.0, 355.0, ntemp)
    press_ref = np.logspace(np.log10(1.0925e5), np.log10(1.0), npres)
    vmr_ref = np.empty((2, len(GASES) + 1, ntemp))
    vmr_ref[:, 0, :] = 1.0
    for i, g in enumerate(GASES):
        prof = VMR[g] * (1.0 + 0.05 * np.sin(np.linspace(0, 3, ntemp) + i))
        vmr_ref[0, i + 1] = prof
        vmr_ref[1, i + 1] = prof * (0.2 if g == "h2o" else 1.0)
    ks, _ = flavors(nbnd)
    edges = np.linspace(10.0, 50000.0 if sw else 3250.0, nbnd + 1)
    mlo = minors(kd["nminor_lower"], nbnd, width)
    mup = minors(kd["nminor_upper"], nbnd, width)
    raw = dict(
        gas_names=list(GASES), key_species=ks,
        band_lims_gpt=np.stack([np.arange(nbnd) * width + 1,
                                (np.arange(nbnd) + 1) * width], axis=1),
        band_lims_wvn=np.stack([edges[:-1], edges[1:]], axis=1),
        press_ref=press_ref, press_ref_trop=9948.0, temp_ref=temp_ref,
        vmr_ref=vmr_ref,
        kmajor=draw.uniform((ntemp, neta, npres + 1, ngpt), 1e-23, 5e-21),
        kminor_lower=draw.uniform((ntemp, neta, mlo[6]), 1e-25, 5e-23),
        kminor_upper=draw.uniform((ntemp, neta, mup[6]), 1e-25, 5e-23),
        gas_minor=[m[1] for m in MINORS],
        identifier_minor=[m[0] for m in MINORS],
        minor_gases_lower=mlo[0], minor_gases_upper=mup[0],
        minor_limits_gpt_lower=mlo[1], minor_limits_gpt_upper=mup[1],
        minor_scales_with_density_lower=mlo[2],
        minor_scales_with_density_upper=mup[2],
        scaling_gas_lower=mlo[3], scaling_gas_upper=mup[3],
        scale_by_complement_lower=mlo[4], scale_by_complement_upper=mup[4],
        kminor_start_lower=mlo[5], kminor_start_upper=mup[5])
    if sw:
        raw.update(
            rayl_lower=draw.uniform((ntemp, neta, ngpt), 1e-27, 5e-25),
            rayl_upper=draw.uniform((ntemp, neta, ngpt), 1e-27, 5e-25),
            solar_quiet=np.linspace(2.0, 10.0, ngpt),
            solar_facular=np.linspace(0.01, 0.1, ngpt),
            solar_sunspot=np.linspace(0.005, 0.05, ngpt),
            tsi_default=1360.86, mg_default=0.1567652, sb_default=902.7126)
    else:
        tgrid = torch.linspace(temp_ref[0], temp_ref[-1], config["ntemp_planck"],
                               device=draw.device)
        w = draw.uniform((nbnd,), 0.5, 1.5)
        pfrac = draw.uniform((ntemp, neta, npres + 1, nbnd, width), 0.5, 1.5)
        pfrac = pfrac / pfrac.sum(-1, keepdim=True)
        raw.update(
            totplnk=5.670374419e-8 * tgrid[:, None] ** 4 * (w / w.sum())[None],
            planck_frac=pfrac.reshape(ntemp, neta, npres + 1, ngpt),
            optimal_angle_fit=np.stack([np.full(nbnd, -0.5),
                                        np.full(nbnd, 1.7)]))
    return raw


def cloud_raw(config: dict, band_lims_wvn, draw: Draw) -> dict:
    """CloudOpticsRRTMGP.load's keyword arrays on the given bands: liquid
    (nsize, nbnd) and ice (nsize, nbnd, nrough) tables drawn on the
    device, in the ranges of the port's synthetic cloud tables."""
    nbnd = len(band_lims_wvn)
    nl, ni, nr = (config["cloud_nsize_liq"], config["cloud_nsize_ice"],
                  config["cloud_nrough"])
    return dict(
        band_lims_wvn=band_lims_wvn, radliq_lwr=2.5, radliq_upr=21.5,
        diamice_lwr=10.0, diamice_upr=180.0,
        extliq=draw.uniform((nl, nbnd), 5e-3, 4e-2),
        ssaliq=draw.uniform((nl, nbnd), 0.4, 0.9999),
        asyliq=draw.uniform((nl, nbnd), 0.6, 0.95),
        extice=draw.uniform((ni, nbnd, nr), 5e-3, 4e-2),
        ssaice=draw.uniform((ni, nbnd, nr), 0.4, 0.9999),
        asyice=draw.uniform((ni, nbnd, nr), 0.6, 0.95))


def host(raw: dict) -> dict:
    """``raw`` with its tensors as float64 numpy arrays (the program's
    constructors take host arrays and cast them to their dtype)."""
    return {k: v.double().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in raw.items()}


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's data from the seed: ``lw``, ``sw`` (k-distribution
    arrays), ``cloud_lw``, ``cloud_sw`` (cloud arrays, for configurations
    with clouds), the problem's own tables under its keys, and ``pool``,
    the ``traffic["pool"]`` states the loop cycles through."""
    mod = harness.load("traffic", config["problem"])
    draw = Draw(seed, device)
    out = dict(lw=kdist_raw(config, False, draw),
               sw=kdist_raw(config, True, draw))
    if "cloud_nsize_liq" in config:
        out["cloud_lw"] = cloud_raw(config, out["lw"]["band_lims_wvn"], draw)
        out["cloud_sw"] = cloud_raw(config, out["sw"]["band_lims_wvn"], draw)
    if hasattr(mod, "tables"):
        out.update(mod.tables(config, dict(out), draw))
    out["pool"] = [mod.state(config, traffic, draw)
                   for _ in range(traffic["pool"])]
    return out
