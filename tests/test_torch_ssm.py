"""The port's SSM gas optics (``models/ssm.py``) and analytic Planck
source (``ops/planck.py``) against the JAX package on the CPU.

  * The cases of tests/test_ssm.py, one for one, with the same bounds:
    the defaults, configure's four ValueErrors (and the fifth, tstar or
    tsi below zero), the LW and SW problems end to end through rte_lw /
    rte_sw, the tlev requirement, pressure broadening (rtol 1e-12), the
    gray cloud optics; test_ssm_jit_compatible's counterpart is the
    orientation given (what a traced call needs) against the one inferred
    from the pressures, bit for bit: the port traces nothing.
  * Against the JAX package in float64 on the same RCEMIP atmosphere:
    the tables and grid equal, tau, the sources, the TOA flux and the LW
    and SW fluxes within 1e-10 of the largest value; ``ssm_from_jax``;
    ``b_nu`` and ``planck_source`` within 1e-13 relative; the public-API
    all-sky step with SSM and no cloud optics (SSM's gray clouds).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu import rte_lw as jrte_lw, rte_sw as jrte_sw  # noqa: E402
from rte_rrtmgp_tpu.models import ssm as jssm  # noqa: E402
from rte_rrtmgp_tpu.ops import planck as jplanck  # noqa: E402
from rte_rrtmgp_tpu.utils.profiles import (  # noqa: E402
    rcemip_profiles as jrcemip_profiles)
from rte_rrtmgp_tpu_torch.convert import ssm_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.models.ssm import (TSI_SSM, OpticsSSM,  # noqa: E402
                                             ssm_lw_defaults,
                                             ssm_sw_defaults)
from rte_rrtmgp_tpu_torch.ops.planck import b_nu, planck_source  # noqa: E402
from rte_rrtmgp_tpu_torch.rte import rte_lw, rte_sw  # noqa: E402
from rte_rrtmgp_tpu_torch.utils.profiles import rcemip_profiles  # noqa: E402

NCOL, NLAY = 4, 40
SIGMA = 5.670374419e-8
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def atmosphere():
    """The RCEMIP atmosphere as float64 tensors and its gas store."""
    play, plev, tlay, tlev, _, gas = rcemip_profiles(NCOL, NLAY)
    t = torch.from_numpy
    return t(play), t(plev), t(tlay), t(tlev), gas


def close(got, ref, tol=1e-10):
    """got within tol of the largest |ref|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_ssm_configure_defaults():
    lw = ssm_lw_defaults(**CPU)
    assert lw.source_is_internal() and not lw.source_is_external()
    assert lw.grid.ngpt == 41
    assert tuple(lw.absorption_coeffs.shape) == (2, 41)
    k_h2o = lw.absorption_coeffs[0]
    assert k_h2o[0] > k_h2o[10]
    sw = ssm_sw_defaults(**CPU)
    assert sw.source_is_external()
    np.testing.assert_allclose(float(sw.toa_src.sum()), TSI_SSM, rtol=1e-12)
    assert lw.device == torch.device("cpu")


def test_ssm_configure_validation():
    nus = np.linspace(50.0, 3000.0, 11)
    cfg = lambda *a, **kw: OpticsSSM.configure(*a, **kw, **CPU)
    with pytest.raises(ValueError, match="nu"):
        cfg(("h2o",), [[1.0, 1.0, 100.0, 10.0]], nus, 100.0, 3500.0)
    with pytest.raises(ValueError, match="gas index"):
        cfg(("h2o",), [[2.0, 1.0, 100.0, 10.0]], nus, 0.0, 3500.0)
    with pytest.raises(ValueError, match="kappa0"):
        cfg(("h2o",), [[1.0, -1.0, 100.0, 10.0]], nus, 0.0, 3500.0)
    with pytest.raises(ValueError, match="molecular weight"):
        cfg(("xe",), [[1.0, 1.0, 100.0, 10.0]], nus, 0.0, 3500.0)
    with pytest.raises(ValueError, match="width"):
        cfg(("h2o",), [[1.0, 1.0, 100.0, 0.0]], nus, 0.0, 3500.0)
    with pytest.raises(ValueError, match="tstar"):
        cfg(("h2o",), [[1.0, 1.0, 100.0, 10.0]], nus, 0.0, 3500.0,
            tstar=-1.0)


@pytest.mark.parametrize("which", ["lw", "sw"])
def test_ssm_tables_match_jax(which):
    got = (ssm_lw_defaults if which == "lw" else ssm_sw_defaults)(**CPU)
    ref = (jssm.ssm_lw_defaults if which == "lw" else jssm.ssm_sw_defaults)()
    assert got.grid == type(got.grid)(
        band_lims_wvn=tuple(ref.grid.band_lims_wvn),
        band_lims_gpt=tuple(ref.grid.band_lims_gpt))
    assert got.gas_names == ref.gas_names
    np.testing.assert_array_equal(got.mol_weights, ref.mol_weights)
    for f in ("absorption_coeffs", "nus", "dnus", "toa_src"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-14,
                                   atol=0, err_msg=f)
    conv = ssm_from_jax(ref, **CPU)
    for f in dataclasses.fields(OpticsSSM):
        a, b = getattr(conv, f.name), getattr(ref, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        elif f.name != "grid":
            assert np.all(a == b), f.name


def test_ssm_lw_end_to_end(atmosphere):
    play, plev, tlay, tlev, gas = atmosphere
    ssm = ssm_lw_defaults(**CPU)
    props, sources = ssm.gas_optics_lw(play, plev, tlay,
                                       tsfc=np.full(NCOL, 295.0),
                                       gas_concs=gas, tlev=tlev)
    assert tuple(props.tau.shape) == (NCOL, NLAY, 41)
    assert bool((props.tau >= 0).all())
    f = rte_lw(props, sources, torch.ones((NCOL, 1), dtype=torch.float64))
    olr = f.flux_up[:, 0].numpy()
    assert np.all(olr > 0.2 * SIGMA * 295.0 ** 4)
    assert np.all(olr < SIGMA * 300.0 ** 4)
    assert np.all(f.flux_up[:, -1].numpy() > olr)
    np.testing.assert_allclose(f.flux_dn[:, 0].numpy(), 0.0, atol=1e-12)


def test_ssm_lw_requires_tlev(atmosphere):
    play, plev, tlay, _, gas = atmosphere
    ssm = ssm_lw_defaults(**CPU)
    with pytest.raises(ValueError, match="tlev"):
        ssm.gas_optics_lw(play, plev, tlay, np.full(NCOL, 295.0), gas)
    with pytest.raises(ValueError, match="external"):
        ssm_sw_defaults(**CPU).gas_optics_lw(play, plev, tlay,
                                             np.full(NCOL, 295.0), gas,
                                             tlev=plev)
    with pytest.raises(ValueError, match="internal"):
        ssm.gas_optics_sw(play, plev, tlay, gas)


def test_ssm_sw_end_to_end(atmosphere):
    play, plev, tlay, _, gas = atmosphere
    ssm = ssm_sw_defaults(**CPU)
    props, toa = ssm.gas_optics_sw(play, plev, tlay, gas)
    assert tuple(toa.shape) == (NCOL, 41)
    np.testing.assert_allclose(toa.sum(-1).numpy(), TSI_SSM, rtol=1e-6)
    alb = torch.full((NCOL, 1), 0.1, dtype=torch.float64)
    f = rte_sw(props, torch.full((NCOL,), 0.7, dtype=torch.float64), toa,
               alb, alb)
    inc = TSI_SSM * 0.7
    np.testing.assert_allclose(f.flux_dn[:, 0].numpy(), inc, rtol=1e-6)
    assert np.all(f.flux_dn[:, -1].numpy() < inc)
    assert np.all(f.flux_dn[:, -1].numpy() > 0.3 * inc)


def test_ssm_pressure_broadening(atmosphere):
    play, plev, tlay, tlev, gas = atmosphere
    ssm = ssm_lw_defaults(**CPU)
    ssm_nopb = dataclasses.replace(ssm, pref=0.0)
    tsfc = np.full(NCOL, 295.0)
    p1, _ = ssm.gas_optics_lw(play, plev, tlay, tsfc, gas, tlev=tlev)
    p2, _ = ssm_nopb.gas_optics_lw(play, plev, tlay, tsfc, gas, tlev=tlev)
    ratio = (p1.tau / p2.tau).numpy()
    expected = np.broadcast_to((play / ssm.pref).numpy()[:, :, None],
                               ratio.shape)
    np.testing.assert_allclose(ratio, expected, rtol=1e-12)


@pytest.mark.parametrize("scattering", [True, False])
def test_ssm_cloud_optics(scattering):
    ssm = ssm_lw_defaults(**CPU)
    clwp = np.zeros((NCOL, NLAY))
    clwp[:, 20] = 0.05  # kg/m2
    cld = ssm.cloud_optics(clwp, np.zeros((NCOL, NLAY)),
                           scattering=scattering)
    tau = cld.tau.numpy()
    np.testing.assert_allclose(tau[:, 20, :], 1000.0 * 0.05 * 50.0)
    assert np.all(tau[:, :20, :] == 0)
    sw = ssm_sw_defaults(**CPU)
    ref = jssm.ssm_sw_defaults().cloud_optics(clwp, clwp[:, ::-1],
                                              scattering=scattering)
    got = sw.cloud_optics(clwp, clwp[:, ::-1], scattering=scattering)
    assert type(got).__name__ == type(ref).__name__
    for f in ("tau", "ssa", "g")[:3 if scattering else 1]:
        close(getattr(got, f), getattr(ref, f), 1e-15)


def test_ssm_top_at_1_given_matches_inferred(atmosphere):
    play, plev, tlay, tlev, gas = atmosphere
    ssm = ssm_lw_defaults(**CPU)
    tsfc = np.full(NCOL, 295.0)
    emis = torch.ones((NCOL, 1), dtype=torch.float64)
    ups = []
    for top in (True, None):
        props, src = ssm.gas_optics_lw(play, plev, tlay, tsfc, gas,
                                       tlev=tlev, top_at_1=top)
        assert props.top_at_1
        ups.append(rte_lw(props, src, emis).flux_up)
    assert torch.equal(ups[0], ups[1])


@pytest.mark.parametrize("orientation", ["top", "bottom"])
def test_ssm_matches_jax_f64(orientation):
    """tau, sources, TOA flux and fluxes against the JAX package."""
    jplay, jplev, jtlay, jtlev, _, jgas = jrcemip_profiles(NCOL, NLAY)
    play, plev, tlay, tlev, _, gas = rcemip_profiles(NCOL, NLAY)
    if orientation == "bottom":
        flip = lambda a: np.ascontiguousarray(a[:, ::-1])
        jplay, jplev, jtlay, jtlev = map(flip, (jplay, jplev, jtlay, jtlev))
        play, plev, tlay, tlev = map(flip, (play, plev, tlay, tlev))
        from rte_rrtmgp_tpu_torch.drivers.rfmip import _flip_lay
        gas = _flip_lay(gas)
        from rte_rrtmgp_tpu.drivers.rfmip import _flip_lay as jflip
        jgas = jflip(jgas)
    t = torch.from_numpy
    tsfc = np.linspace(285.0, 300.0, NCOL)
    lw, jlw = ssm_lw_defaults(**CPU), jssm.ssm_lw_defaults()
    props, src = lw.gas_optics_lw(t(play), t(plev), t(tlay), tsfc, gas,
                                  tlev=t(tlev))
    jprops, jsrc = jlw.gas_optics_lw(jplay, jplev, jtlay, tsfc, jgas,
                                     tlev=jtlev)
    assert props.top_at_1 == jprops.top_at_1 == (orientation == "top")
    close(props.tau, jprops.tau)
    for f in ("lay_source", "lev_source", "sfc_source", "sfc_source_jac"):
        close(getattr(src, f), getattr(jsrc, f))
    emis = np.full((NCOL, 1), 0.95)
    f, jf = rte_lw(props, src, t(emis)), jrte_lw(jprops, jsrc, emis)
    close(f.flux_up, jf.flux_up)
    close(f.flux_dn, jf.flux_dn)

    sw, jsw = ssm_sw_defaults(**CPU), jssm.ssm_sw_defaults()
    props, toa = sw.gas_optics_sw(t(play), t(plev), t(tlay), gas)
    jprops, jtoa = jsw.gas_optics_sw(jplay, jplev, jtlay, jgas)
    for a, b in ((props.tau, jprops.tau), (props.ssa, jprops.ssa),
                 (props.g, jprops.g), (toa, jtoa)):
        close(a, b)
    mu0 = np.linspace(0.2, 0.9, NCOL)
    alb = np.full((NCOL, 1), 0.1)
    f = rte_sw(props, t(mu0), toa, t(alb), t(alb))
    jf = jrte_sw(jprops, mu0, jtoa, alb, alb)
    for a, b in ((f.flux_up, jf.flux_up), (f.flux_dn, jf.flux_dn),
                 (f.flux_dn_dir, jf.flux_dn_dir)):
        close(a, b)


def test_planck_matches_jax():
    t = np.array([[180.0, 250.0], [295.0, 5760.0]])
    nus = np.linspace(50.0, 45000.0, 41)
    dnus = np.full(41, 10.0)
    for got, ref in (
            (b_nu(torch.from_numpy(t)[..., None], torch.from_numpy(nus)),
             jplanck.b_nu(jnp.asarray(t)[..., None], jnp.asarray(nus))),
            (planck_source(torch.from_numpy(t), torch.from_numpy(nus),
                           torch.from_numpy(dnus)),
             jplanck.planck_source(t, jnp.asarray(nus), jnp.asarray(dnus)))):
        assert tuple(got.shape) == (2, 2, 41)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13,
                                   atol=0)


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_allsky_api_ssm_gray_clouds_match_jax(band):
    """The public-API all-sky step with an SSM provider and no cloud
    optics takes SSM's gray clouds from the water paths in kg/m2, as the
    JAX driver's generic branch does (drivers/allsky.py:397-404,
    :436-439): within 1e-10 of the largest flux in float64."""
    from rte_rrtmgp_tpu.drivers import allsky as jallsky
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_api_lw,
                                                     allsky_api_sw,
                                                     make_allsky_inputs)
    inp = make_allsky_inputs(6, 12, dtype=torch.float64, device="cpu")
    jinp = jallsky.make_allsky_inputs(6, 12, dtype=jnp.float64)
    assert float(inp.lwp.sum()) > 0 and float(inp.iwp.sum()) > 0
    if band == "lw":
        got = allsky_api_lw(inp, ssm_lw_defaults(**CPU))
        ref = jallsky.allsky_step_lw(jinp, jssm.ssm_lw_defaults())
        clear = allsky_api_lw(inp, ssm_lw_defaults(**CPU), use_clouds=False)
    else:
        got = allsky_api_sw(inp, ssm_sw_defaults(**CPU))
        ref = jallsky.allsky_step_sw(jinp, jssm.ssm_sw_defaults())
        clear = allsky_api_sw(inp, ssm_sw_defaults(**CPU), use_clouds=False)
    close(got.flux_up, ref.flux_up)
    close(got.flux_dn, ref.flux_dn)
    assert not torch.equal(got.flux_up, clear.flux_up)
