"""Analytic atmospheres (numpy; no data files).

Counterpart of ``rte_rrtmgp_tpu.utils.profiles``: the RCEMIP protocol
profiles (``rcemip_profiles``, reference tests/mo_rcemip_profiles.F90:
30-146) used by the solver-variant script, and the all-sky driver's
(``allsky_profiles``, reference examples/all-sky/rrtmgp_allsky.F90:
496-587 ``compute_profiles``); the gas store holds float64 tensors.
"""
from __future__ import annotations

import numpy as np

from ..gas_concs import GasConcs

__all__ = ["rcemip_profiles", "allsky_profiles"]

# RCEMIP parameters (reference mo_rcemip_profiles.F90:32-49)
_G = 9.79764
_RD = 287.04
_P0 = 101480.0
_QT = 1.0e-14
_ZQ1, _ZQ2 = 4000.0, 7500.0
_ZT = 15000.0
_GAMMA = 0.0067
_CHI_CO2, _CHI_CH4, _CHI_N2O = 348.0e-6, 1650.0e-9, 306.0e-9
_SST, _Q0 = 295.0, 0.012
_G1, _G2, _G3 = 3.6478, 0.83209, 11.3515
_TV0 = _SST * (1 + 0.608 * _Q0)
_TVT = _TV0 - _GAMMA * _ZT
_PT = _P0 * (_TVT / _TV0) ** (_G / (_RD * _GAMMA))
_M_AIR, _M_H2O = 0.028964, 0.018016


def _zt_given_p(p):
    """z, T, q (vmr), o3 (vmr) given pressure in Pa (reference
    zt_given_p)."""
    p = np.asarray(p, np.float64)
    tropo = p > _PT
    z = np.where(tropo,
                 (_TV0 / _GAMMA) * (1 - (p / _P0) ** ((_RD * _GAMMA) / _G)),
                 _ZT + (_RD * _TVT / _G) * np.log(np.maximum(_PT / p,
                                                             1e-300)))
    q_local = np.where(tropo, _Q0 * np.exp(-z / _ZQ1)
                       * np.exp(-((z / _ZQ2) ** 2)), _QT)
    tv = np.where(tropo, _TV0 - _GAMMA * z, _TVT)
    temp = tv / (1 + 0.608 * q_local)
    o3 = _G1 * (p / 100.0) ** _G2 * np.exp(-p / (100.0 * _G3)) * 1.0e-6
    return z, temp, q_local * _M_AIR / _M_H2O, o3


def rcemip_profiles(ncol: int, nlay: int, p_min: float = 1.0):
    """Equal-pressure-spacing RCEMIP column replicated over ``ncol``
    (reference make_rcemip_profiles, tests/mo_rcemip_profiles.F90:
    117-144). Returns (play, plev, tlay, tlev, z_lay, gas_concs), numpy
    arrays (ncol, nlay[+1]) with top at index 0 (p_min first)."""
    plev_1d = p_min + (_P0 - p_min) / nlay * np.arange(nlay + 1)
    play_1d = 0.5 * (plev_1d[:-1] + plev_1d[1:])
    z, tlay_1d, q, o3 = _zt_given_p(play_1d)
    _, tlev_1d, _, _ = _zt_given_p(plev_1d)

    def rep(a):
        return np.broadcast_to(a[None, :], (ncol,) + a.shape).copy()

    gas = (GasConcs.empty()
           .set_vmr("co2", _CHI_CO2)
           .set_vmr("ch4", _CHI_CH4)
           .set_vmr("n2o", _CHI_N2O)
           .set_vmr("h2o", q)
           .set_vmr("o3", o3)
           .set_vmr("o2", 0.21))
    return (rep(play_1d), rep(plev_1d), rep(tlay_1d), rep(tlev_1d), rep(z),
            gas)


def allsky_profiles(ncol: int, nlay: int):
    """The all-sky benchmark's analytic RCE-like atmosphere (reference
    examples/all-sky/rrtmgp_allsky.F90:496-587 ``compute_profiles``):
    surface 300 K, moist-adiabat-ish troposphere, isothermal stratosphere.

    Returns (play, plev, tlay, tlev, gas_concs) with top at index 0.
    """
    # The reference uses the same RCEMIP functional form with SST=300
    z_trop = _ZT
    sst = 300.0
    tv0 = sst * (1 + 0.608 * _Q0)
    tvt = tv0 - _GAMMA * z_trop
    pt = _P0 * (tvt / tv0) ** (_G / (_RD * _GAMMA))

    plev_1d = 1.0 + (_P0 - 1.0) / nlay * np.arange(nlay + 1)
    play_1d = 0.5 * (plev_1d[:-1] + plev_1d[1:])

    def profile(p):
        tropo = p > pt
        z = np.where(tropo,
                     (tv0 / _GAMMA) * (1 - (p / _P0) ** ((_RD * _GAMMA) / _G)),
                     z_trop + (_RD * tvt / _G) * np.log(np.maximum(pt / p, 1e-300)))
        q_l = np.where(tropo, _Q0 * np.exp(-z / _ZQ1) * np.exp(-((z / _ZQ2) ** 2)), _QT)
        tv = np.where(tropo, tv0 - _GAMMA * z, tvt)
        return tv / (1 + 0.608 * q_l), q_l * _M_AIR / _M_H2O, z

    tlay_1d, q, _ = profile(play_1d)
    tlev_1d, _, _ = profile(plev_1d)
    o3 = _G1 * (play_1d / 100.0) ** _G2 * np.exp(-play_1d / (100.0 * _G3)) * 1.0e-6

    def rep(a):
        return np.broadcast_to(a[None, :], (ncol,) + a.shape).copy()

    gas = (GasConcs.empty()
           .set_vmr("h2o", q)
           .set_vmr("o3", o3)
           .set_vmr("co2", 348.0e-6)
           .set_vmr("ch4", 1650.0e-9)
           .set_vmr("n2o", 306.0e-9)
           .set_vmr("n2", 0.7808)
           .set_vmr("o2", 0.2095)
           .set_vmr("co", 0.0))
    return rep(play_1d), rep(plev_1d), rep(tlay_1d), rep(tlev_1d), gas
