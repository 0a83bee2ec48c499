"""The all-sky problem with MERRA aerosols (configurations with
``"problem": "allsky_aer"``): the reference's all-sky example with its
aerosols (rrtmgp_allsky.F90:353-404, :666-739).

  * :func:`tables`: the MERRA/GOCART tables on the LW and the SW bands
    (``AerosolOpticsMERRA.load``'s keyword arrays), drawn after the
    shared k-distribution and cloud tables, so those stay the all-sky
    problem's bit for bit; the layout is the port's synthetic one
    (``utils/synthetic.synthetic_aerosol_raw``): size bins log-spaced from
    0.1 to 10 microns, the RH grid from 0 to 0.99, ext in [50, 5000]
    m2/kg, ssa and g in [0.3, 0.95];
  * :func:`state`: ``traffic/allsky.state`` plus the example's aerosol
    fields (no draws): sulfate (type 3, 0.2 microns, 1e-6 kg/m2) at
    50-100 hPa and dust (type 1, 0.5 microns, 3e-5 kg/m2) at 700-900 hPa,
    in the odd columns (1-based), and the relative humidity of each
    state's temperature and water vapour (the example's get_relhum,
    :744-786), clipped to [0, 1];
  * :func:`shapes`: the tables' sizes and the stream's chunk for
    ``work/aerosol_props.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from torch_bench.traffic import allsky
from torch_bench.traffic.generator import Draw

# type codes (mo_aerosol_optics_rrtmgp_merra.F90:43-52)
DUST, SULF = 1, 3
# molar masses of water and dry air [kg/mol] (mo_gas_optics_constants)
_M_H2O, _M_DRY = 0.018016, 0.028964


def _merra(config: dict, band_lims_wvn, draw: Draw) -> dict:
    """The MERRA tables on the given bands in the reference's in-memory
    order (load_lut): dust (3, nbin, nbnd), salt (nrh, 3, nbin, nbnd),
    sulfate, bcar_rh and ocar_rh (nrh, 3, nbnd), bcar and ocar (3, nbnd),
    the value axis (ext, ssa, g); tables drawn on the device."""
    nbnd = len(band_lims_wvn)
    nbin, nrh = config["aerosol_nbin"], config["aerosol_nrh"]
    edges = np.logspace(-1, 1, nbin + 1)

    def tbl(*shape):
        return torch.cat([draw.uniform((1,) + shape, 50.0, 5000.0),
                          draw.uniform((2,) + shape, 0.3, 0.95)])

    rh_major = lambda t: t.movedim(0, 1).contiguous()
    return dict(
        band_lims_wvn=band_lims_wvn,
        merra_aero_bin_lims=np.stack([edges[:-1], edges[1:]]),
        aero_rh=np.linspace(0.0, 0.99, nrh),
        aero_dust_tbl=tbl(nbin, nbnd),
        aero_salt_tbl=rh_major(tbl(nrh, nbin, nbnd)),
        aero_sulf_tbl=rh_major(tbl(nrh, nbnd)),
        aero_bcar_tbl=tbl(nbnd),
        aero_bcar_rh_tbl=rh_major(tbl(nrh, nbnd)),
        aero_ocar_tbl=tbl(nbnd),
        aero_ocar_rh_tbl=rh_major(tbl(nrh, nbnd)))


def tables(config: dict, data: dict, draw: Draw) -> dict:
    return dict(aerosol_lw=_merra(config, data["lw"]["band_lims_wvn"], draw),
                aerosol_sw=_merra(config, data["sw"]["band_lims_wvn"], draw))


def relhum(play, tlay, h2o):
    """Layer relative humidity from pressure [Pa], temperature [K] and
    the water vapour's vmr (rrtmgp_allsky.F90:744-786), clipped to
    [0, 1], as float32 on the inputs' device. Formed in numpy float64 on
    the host: torch's CPU exp takes its vector or its scalar path by where
    its threads split the tensor, so its bits could move between runs."""
    host = lambda x: x.double().cpu().numpy()
    mmr = host(h2o) * (_M_H2O / _M_DRY)
    q = np.maximum(1.0e-7, mmr / (1.0 + mmr))
    t = host(tlay)
    es = np.exp(17.67 * (t - 273.16) / (t - 29.65))
    rh = np.clip(0.01 * (0.263 * host(play) * q) / es, 0.0, 1.0)
    return torch.as_tensor(rh.astype(np.float32), device=play.device)


def state(config: dict, traffic: dict, draw: Draw) -> dict:
    """One all-sky state (``traffic/allsky.state``) with the example's
    aerosols and its relative humidity."""
    s = allsky.state(config, traffic, draw)
    ncol, nlay = s["play"].shape
    dev = s["play"].device
    odd = (torch.arange(1, ncol + 1, device=dev) % 2 != 0)[:, None]
    p = s["play"]
    sulf = (p > 50e2) & (p < 100e2) & odd
    dust = (p > 700e2) & (p < 900e2) & odd
    pick = lambda a, b: torch.where(sulf, a, torch.where(dust, b, 0.0))
    return dict(
        s, aero_type=pick(SULF, DUST).to(torch.int32),
        aero_size=pick(0.2, 0.5).float(), aero_mass=pick(1e-6, 3e-5).float(),
        relhum=relhum(p, s["tlay"], s["h2o"].expand(ncol, nlay)))


def shapes(config: dict) -> dict:
    return dict(aerosol_nbin=config["aerosol_nbin"],
                aerosol_nrh=config["aerosol_nrh"], chunk=config["chunk"])
