"""The port's descriptor prep and plain gas-optics twins against the JAX
package (float64, CPU).

On the oracle k-distribution of tests/rrtmgp_synthetic.py (4 gases,
ragged flavors, a random atmosphere whose columns have their own
pressure profiles) and on the all-sky configuration, the port's column
amounts, interpolation coefficients, optical depths and Planck sources
equal the JAX package's XLA path and tests/rrtmgp_oracle.py. Indices
must be equal; floating fields agree to rtol 1e-12 (both compute the same
float64 expressions, possibly in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rrtmgp_oracle import oracle_interpolation  # noqa: E402
from rrtmgp_synthetic import GASES, sample_atmosphere, synthetic_raw  # noqa: E402
from rte_rrtmgp_tpu.gas_concs import GasConcs as JGasConcs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.models.rrtmgp.kdist import KDist as JKDist  # noqa: E402
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP, get_col_dry, interp_tlev)
from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.gas_optics import (  # noqa: E402
    planck_sources, tau_major, tau_minor, tau_rayleigh)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import _split_minors  # noqa: E402

RTOL = 1e-12
F64 = torch.float64


@pytest.fixture(scope="module", params=[False, True], ids=["lw", "sw"])
def case(request):
    sw = request.param
    raw = synthetic_raw(sw=sw)
    jgas = JGasOptics(JKDist.from_raw(GASES, dtype=jnp.float64, **raw))
    gas = GasOpticsRRTMGP(KDist.from_raw(GASES, dtype=F64, device="cpu",
                                         **raw))
    play, plev, tlay, tlev, tsfc, vmr = sample_atmosphere(ncol=4, nlay=9)
    jgc, gc = JGasConcs.empty(), GasConcs.empty()
    for k, v in vmr.items():
        jgc, gc = jgc.set_vmr(k, v), gc.set_vmr(k, v)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    atm = dict(play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc)
    return sw, jgas, jgc, gas, gc, atm, {k: t(v) for k, v in atm.items()}


def test_col_gas_and_interpolation(case):
    _, jgas, jgc, gas, gc, atm, tat = case
    j_cg, j_dry, j_h2o = jgas._col_gas(jnp.asarray(atm["play"]),
                                       jnp.asarray(atm["plev"]),
                                       jnp.asarray(atm["tlay"]), jgc, None)
    cg, dry, h2o = gas.col_gas(tat["play"], tat["plev"], gc)
    assert h2o == j_h2o
    np.testing.assert_allclose(cg.numpy(), np.asarray(j_cg), rtol=RTOL)
    np.testing.assert_allclose(dry.numpy(), np.asarray(j_dry), rtol=RTOL)
    vmr_h2o = gc.get_vmr("h2o", *tat["play"].shape)
    np.testing.assert_allclose(get_col_dry(vmr_h2o, tat["plev"]).numpy(),
                               np.asarray(j_dry), rtol=RTOL)

    ref = jgas._interp(jnp.asarray(atm["play"]), jnp.asarray(atm["tlay"]),
                       j_cg)
    co = gas.interp(tat["play"], tat["tlay"], cg)
    for name in ("jtemp", "jpress", "tropo", "jeta"):
        np.testing.assert_array_equal(getattr(co, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("ftemp", "fpress", "col_mix", "feta"):
        np.testing.assert_allclose(getattr(co, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=1e-15, err_msg=name)

    # the plain-loop NumPy oracle (its conventions: (ncol, nlay, ...))
    orc = oracle_interpolation(jgas.kdist, atm["play"], atm["tlay"],
                               np.moveaxis(cg.numpy(), 0, -1))
    np.testing.assert_array_equal(co.jtemp.numpy(), orc["jtemp"])
    np.testing.assert_array_equal(co.jpress.numpy(), orc["jpress"])
    np.testing.assert_array_equal(co.tropo.numpy(), orc["tropo"])
    np.testing.assert_allclose(co.fpress.numpy(), orc["fpress"], rtol=1e-10)
    np.testing.assert_allclose(np.transpose(co.col_mix.numpy(), (2, 3, 1, 0)),
                               orc["col_mix"], rtol=RTOL)
    # eta position (index + fraction): a value on a grid node may pair
    # either side's index with 0 or 1 as its fraction
    eta = (np.transpose(co.jeta.numpy(), (2, 3, 1, 0))
           + np.transpose(co.feta.numpy(), (2, 3, 1, 0)))
    orc_eta = orc["jeta"] + orc["fminor"][..., 1] / np.where(
        orc["fminor"].sum(-1) > 0, orc["fminor"].sum(-1), 1.0)
    np.testing.assert_allclose(eta, orc_eta, rtol=1e-9, atol=1e-9)


def test_interp_tlev(case):
    _, jgas, _, _, _, atm, tat = case
    ref = jgas.interp_tlev(jnp.asarray(atm["tlay"]), jnp.asarray(atm["play"]),
                           jnp.asarray(atm["plev"]))
    got = interp_tlev(tat["tlay"], tat["play"], tat["plev"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def _port_tau(gas, x):
    tau, pfrac = tau_major(x.co, x.kmajor, getattr(x, "planck_frac", None),
                           x.gpoint_flavor)
    lo, up = _split_minors(x.minors)
    tau = tau_minor(tau, x.co, x.kminor_lower, lo, x.minor_scale[:len(lo)])
    tau = tau_minor(tau, x.co, x.kminor_upper, up, x.minor_scale[len(lo):])
    return tau, pfrac


def test_optical_depths_and_sources(case):
    """Major + minor tau (+ Rayleigh combine for SW) and the Planck
    sources from the port's twins equal the JAX XLA gas optics."""
    sw, jgas, jgc, gas, gc, atm, tat = case
    lane = lambda a: np.transpose(a.numpy(), (2, 1, 0))   # -> (ncol, nlay, g)
    ncol = atm["play"].shape[0]
    if sw:
        props, _ = jgas.gas_optics_sw(atm["play"], atm["plev"], atm["tlay"],
                                      jgc, top_at_1=True)
        alb = torch.full((gas.ngpt, ncol), 0.1, dtype=F64)
        mu0 = torch.full(tat["play"].T.shape, 0.5, dtype=F64)
        x = gas.sw_fused_inputs(tat["play"], tat["plev"], tat["tlay"], gc,
                                mu0=mu0, sfc_alb_dir=alb, sfc_alb_dif=alb)
        tau, _ = _port_tau(gas, x)
        ray = tau_rayleigh(x.co, x.krayl, x.gpoint_flavor, x.rayscale)
        t = tau + ray
        np.testing.assert_allclose(lane(t), np.asarray(props.tau), rtol=RTOL)
        np.testing.assert_allclose(lane(ray / t), np.asarray(props.ssa),
                                   rtol=1e-11)
        return
    props, src = jgas.gas_optics_lw(atm["play"], atm["plev"], atm["tlay"],
                                    atm["tsfc"], jgc, tlev=atm["tlev"],
                                    top_at_1=True)
    emis = torch.ones((gas.ngpt, ncol), dtype=F64)
    x = gas.lw_fused_inputs(tat["play"], tat["plev"], tat["tlay"],
                            tat["tsfc"], gc, sfc_emis=emis, tlev=tat["tlev"],
                            ds=1.0, weight=1.0)
    tau, pfrac = _port_tau(gas, x)
    np.testing.assert_allclose(lane(tau), np.asarray(props.tau), rtol=RTOL)
    sfc, lay, lev, jac = planck_sources(
        pfrac.permute(2, 1, 0), totplnk=x.totplnk, totplnk_delta=x.tp_delta,
        temp_ref_min=x.tp_min, gpt2band=x.gpt2band, tlay=x.tlay.T,
        tlev=x.tlev.T, tsfc=x.tsfc, top_at_1=True)
    for got, ref in ((lay, src.lay_source), (lev, src.lev_source),
                     (sfc, src.sfc_source), (jac, src.sfc_source_jac)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_missing_key_species_raises(case):
    sw, _, _, gas, gc, _, tat = case
    partial = GasConcs.empty().set_vmr("h2o", 1e-3)
    with pytest.raises(ValueError, match="required gases"):
        if sw:
            alb = torch.zeros((gas.ngpt, tat["play"].shape[0]), dtype=F64)
            gas.sw_fused_inputs(tat["play"], tat["plev"], tat["tlay"],
                                partial, mu0=tat["play"].T, sfc_alb_dir=alb,
                                sfc_alb_dif=alb)
        else:
            gas.lw_fused_inputs(tat["play"], tat["plev"], tat["tlay"],
                                tat["tsfc"], partial,
                                sfc_emis=torch.zeros(1), ds=1.0, weight=1.0)
