"""Synthetic optics data at production-like dimensions (numpy).

Counterpart of ``rte_rrtmgp_tpu.utils.synthetic``: ``synthetic_kdist_raw``
is a verbatim copy, and the cloud-table generator draws the same rng
sequence as the JAX package's ``synthetic_cloud_optics``, so both packages
build identical tables from one seed. Numbers are NOT scientifically
meaningful.
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_kdist_raw", "synthetic_cloud_raw", "synthetic_kdist",
           "synthetic_cloud_optics", "GASES_FULL"]

GASES_FULL = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2")


def synthetic_kdist_raw(sw: bool = False, *, ngpt=None, nbnd=None,
                        ntemp=14, npres=59, neta=9, seed=0):
    """Raw-array dict for KDist.from_raw at production-like dimensions."""
    rng = np.random.default_rng(seed + (1 if sw else 0))
    ngpt = ngpt or (224 if sw else 256)
    nbnd = nbnd or (14 if sw else 16)
    if ngpt % nbnd != 0:
        raise ValueError(f"ngpt {ngpt} is not a multiple of nbnd {nbnd}")
    gpt_per_band = ngpt // nbnd
    gases = list(GASES_FULL)
    ngas = len(gases)

    temp_ref = np.linspace(160.0, 355.0, ntemp)
    press_ref = np.logspace(np.log10(1.0925e5), np.log10(1.0), npres)
    press_ref_trop = 9948.0

    vmr_ref = np.empty((2, ngas + 1, ntemp))
    vmr_ref[:, 0, :] = 1.0
    base = np.array([7.6e-3, 3.6e-4, 3.2e-6, 3.2e-7, 1.5e-7, 1.7e-6, 0.209, 0.781])
    for i in range(ngas):
        prof = base[i] * (1.0 + 0.05 * np.sin(np.linspace(0, 3, ntemp) + i))
        vmr_ref[0, i + 1] = prof
        vmr_ref[1, i + 1] = prof * (0.2 if gases[i] == "h2o" else 1.0)

    # key species: mix of gas pairs across bands (1-based indices)
    pair_pool = [(1, 2), (1, 3), (2, 3), (1, 4), (1, 6), (2, 2), (0, 0), (1, 1)]
    key_species = np.zeros((2, 2, nbnd), np.int64)
    for b in range(nbnd):
        lo = pair_pool[b % len(pair_pool)]
        hi = pair_pool[(b + 3) % len(pair_pool)]
        key_species[:, 0, b] = lo
        key_species[:, 1, b] = hi

    band_lims_gpt = np.stack([np.arange(nbnd) * gpt_per_band + 1,
                              (np.arange(nbnd) + 1) * gpt_per_band], axis=1)
    edges = np.linspace(10.0, 3250.0 if not sw else 50000.0, nbnd + 1)
    band_lims_wvn = np.stack([edges[:-1], edges[1:]], axis=1)

    def table(shape, lo, hi):
        return rng.uniform(lo, hi, shape)

    kmajor = table((ntemp, neta, npres + 1, ngpt), 1e-23, 5e-21)

    # minor gases: several intervals per atmosphere with varied scaling
    def minors(n, width):
        names, limits, swd, sgas, sbc, starts = [], [], [], [], [], []
        tot = 1
        opts = [("h2o_slf", True, "h2o", False), ("h2o_frg", True, "h2o", True),
                ("n2o", True, "", False), ("ch4", False, "", False),
                ("co", True, "", False), ("o3", False, "", False)]
        for i in range(n):
            nm, d, sg, cb = opts[i % len(opts)]
            names.append(nm)
            g0 = (i * 2 * width) % (ngpt - width) + 1
            limits.append((g0, g0 + width - 1))
            swd.append(d)
            sgas.append(sg)
            sbc.append(cb)
            starts.append(tot)
            tot += width
        return (names, np.asarray(limits), np.asarray(swd), sgas,
                np.asarray(sbc), np.asarray(starts), tot - 1)

    (mgl, lim_l, swd_l, sg_l, sbc_l, st_l, ncont_l) = minors(16, gpt_per_band)
    (mgu, lim_u, swd_u, sg_u, sbc_u, st_u, ncont_u) = minors(12, gpt_per_band)

    raw = dict(
        gas_names=gases,
        key_species=key_species,
        band_lims_gpt=band_lims_gpt,
        band_lims_wvn=band_lims_wvn,
        press_ref=press_ref,
        press_ref_trop=press_ref_trop,
        temp_ref=temp_ref,
        vmr_ref=vmr_ref,
        kmajor=kmajor,
        kminor_lower=table((ntemp, neta, ncont_l), 1e-25, 5e-23),
        kminor_upper=table((ntemp, neta, ncont_u), 1e-25, 5e-23),
        gas_minor=["n2o", "h2o", "h2o", "ch4", "co", "o3"],
        identifier_minor=["n2o", "h2o_slf", "h2o_frg", "ch4", "co", "o3"],
        minor_gases_lower=mgl, minor_gases_upper=mgu,
        minor_limits_gpt_lower=lim_l, minor_limits_gpt_upper=lim_u,
        minor_scales_with_density_lower=swd_l,
        minor_scales_with_density_upper=swd_u,
        scaling_gas_lower=sg_l, scaling_gas_upper=sg_u,
        scale_by_complement_lower=sbc_l, scale_by_complement_upper=sbc_u,
        kminor_start_lower=st_l, kminor_start_upper=st_u,
    )
    if sw:
        raw.update(
            rayl_lower=table((ntemp, neta, ngpt), 1e-27, 5e-25),
            rayl_upper=table((ntemp, neta, ngpt), 1e-27, 5e-25),
            solar_quiet=np.linspace(2.0, 10.0, ngpt),
            solar_facular=np.linspace(0.01, 0.1, ngpt),
            solar_sunspot=np.linspace(0.005, 0.05, ngpt),
            tsi_default=1360.86, mg_default=0.1567652, sb_default=902.7126,
        )
    else:
        nplnk = 196
        tgrid = np.linspace(temp_ref[0], temp_ref[-1], nplnk)
        w = rng.dirichlet(np.full(nbnd, 4.0))
        totplnk = 5.670374419e-8 * tgrid[:, None] ** 4 * w[None, :]
        pfrac = rng.uniform(0.5, 1.5, (ntemp, neta, npres + 1, ngpt))
        for b in range(nbnd):
            g0, g1 = b * gpt_per_band, (b + 1) * gpt_per_band
            pfrac[..., g0:g1] /= pfrac[..., g0:g1].sum(-1, keepdims=True)
        raw.update(
            totplnk=totplnk,
            planck_frac=pfrac,
            optimal_angle_fit=np.stack([np.full(nbnd, -0.5),
                                        np.full(nbnd, 1.7)]),
        )
    return raw


def synthetic_kdist(sw: bool = False, *, dtype=None, device="cpu", **kw):
    """The port's KDist built from :func:`synthetic_kdist_raw`."""
    import torch

    from ..models.rrtmgp.kdist import KDist
    raw = synthetic_kdist_raw(sw=sw, **kw)
    return KDist.from_raw(GASES_FULL, dtype=dtype or torch.float32,
                          device=device, **raw)


def synthetic_cloud_raw(nbnd=16, nsize_liq=25, nsize_ice=25, nrgh=3,
                        band_lims_wvn=None, seed=0):
    """Raw-array dict for CloudOpticsRRTMGP.load, drawn in the same order
    as the JAX package's ``synthetic_cloud_optics``."""
    rng = np.random.default_rng(seed)
    if band_lims_wvn is None:
        edges = np.linspace(10.0, 3250.0, nbnd + 1)
        band_lims_wvn = np.stack([edges[:-1], edges[1:]], axis=1)
    return dict(
        band_lims_wvn=band_lims_wvn, radliq_lwr=2.5, radliq_upr=21.5,
        diamice_lwr=10.0, diamice_upr=180.0,
        extliq=rng.uniform(5e-3, 4e-2, (nsize_liq, nbnd)),
        ssaliq=rng.uniform(0.4, 0.9999, (nsize_liq, nbnd)),
        asyliq=rng.uniform(0.6, 0.95, (nsize_liq, nbnd)),
        extice=rng.uniform(5e-3, 4e-2, (nsize_ice, nbnd, nrgh)),
        ssaice=rng.uniform(0.4, 0.9999, (nsize_ice, nbnd, nrgh)),
        asyice=rng.uniform(0.6, 0.95, (nsize_ice, nbnd, nrgh)))


def synthetic_cloud_optics(nbnd=16, *, dtype=None, device="cpu", **kw):
    """The port's CloudOpticsRRTMGP built from :func:`synthetic_cloud_raw`."""
    import torch

    from ..models.rrtmgp.cloud_optics import CloudOpticsRRTMGP
    return CloudOpticsRRTMGP.load(dtype=dtype or torch.float32,
                                  device=device,
                                  **synthetic_cloud_raw(nbnd=nbnd, **kw))
