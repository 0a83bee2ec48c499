"""The port's public gas-optics API and its gather twins.

  * The cases of tests/test_rrtmgp_gas_optics.py, one for one, on the
    oracle k-distribution of tests/rrtmgp_synthetic.py: load-time
    transforms, the optical depths, Rayleigh combine and Planck sources of
    ``gas_optics_lw/sw`` against the plain-loop NumPy oracle
    (tests/rrtmgp_oracle.py), and the LW/SW pipelines end to end.
  * The twins of the gather kernels (``gas_major_plain``,
    ``gas_minor_plain``, ``gas_rayleigh_plain``, reached through their
    wrappers on CPU tensors; the launch counters must not move) and the
    public
    ``gas_optics_lw/sw`` against the JAX package on the lane-pipeline
    configuration of tests/test_pallas_gas_optics.py (128 x 4 cells, so
    the major kernel's pressure-window guard passes; 32 g-points in 4
    bands, ntemp 6, npres 12), the same arrays given to both: in float64
    against the XLA path (bound 1e-12 relative) and in float32 against
    the Pallas kernels ``major_interp_lane``, ``minor_contributions_lane`` and
    ``rayleigh_k_lane`` in interpret mode (each side computes its own
    float32 descriptors; bound 1e-5 of the largest value, the JAX test's
    own 5e-6 rtol with room for the 8-corner sums taken in another order).
  * The gas optics' own call of the major gather (with the interleaved LW
    table its kernel reads) against the JAX package in float64, and the
    gather's wrapper on its CUDA branch handing the launcher that table
    (LW) or raising without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rrtmgp_oracle import (oracle_interpolation, oracle_planck,  # noqa: E402
                           oracle_tau_absorption, oracle_tau_rayleigh)
from rrtmgp_synthetic import (GASES, NGPT, sample_atmosphere,  # noqa: E402
                              synthetic_raw)
from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.drivers.allsky import make_allsky_inputs as jinputs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.models.rrtmgp.kdist import KDist as JKDist  # noqa: E402
from rte_rrtmgp_tpu.ops import gas_optics as jops  # noqa: E402
from rte_rrtmgp_tpu.ops import gas_optics_pallas as jpallas  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import synthetic_kdist as jax_kdist  # noqa: E402
from rte_rrtmgp_tpu_torch.convert import kdist_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP, get_col_dry)
from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import _split_minors  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (  # noqa: E402
    gas_minor, gas_rayleigh)
from rte_rrtmgp_tpu_torch.rte import rte_lw, rte_sw  # noqa: E402

F64 = torch.float64


def port_gas(vmr, dtype=F64):
    gc = GasConcs.empty()
    for k, v in vmr.items():
        gc = gc.set_vmr(k, v)
    return gc.to(dtype=dtype)


@pytest.fixture(scope="module")
def kd_pair():
    """(JAX KDist for the oracle, port KDist), LW and SW, same raw data."""
    out = {}
    for sw in (False, True):
        raw = synthetic_raw(sw=sw)
        out[sw] = (JKDist.from_raw(GASES, dtype=jnp.float64, **raw),
                   KDist.from_raw(GASES, dtype=F64, device="cpu", **raw))
    return out


@pytest.fixture(scope="module")
def atmos():
    play, plev, tlay, tlev, tsfc, vmr = sample_atmosphere()
    t = lambda a: torch.as_tensor(a, dtype=F64)
    return (dict(play=play, plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc),
            dict(play=t(play), plev=t(plev), tlay=t(tlay), tlev=t(tlev),
                 tsfc=t(tsfc)), port_gas(vmr))


def _oracle_inputs(gas, atm, gc):
    col_gas, col_dry, _ = gas.col_gas(atm[1]["play"], atm[1]["plev"], gc)
    return np.moveaxis(col_gas.numpy(), 0, -1), col_dry.numpy()


# ---------------------------------------------------------------------------
# load-time transforms
# ---------------------------------------------------------------------------

def test_flavor_construction(kd_pair):
    kd = kd_pair[False][1]
    flav = kd.flavor.T.tolist()
    assert [1, 2] in flav and [3, 0] in flav and [2, 2] in flav
    assert kd.nflav == 3
    f12 = flav.index([1, 2])
    assert all(kd.gpoint_flavor[a, g] == f12 for a in (0, 1)
               for g in range(4))


def test_gas_filtering_reduces_minors():
    raw = synthetic_raw(sw=False)
    kd = KDist.from_raw(["h2o", "co2", "o3"], dtype=F64, device="cpu", **raw)
    assert kd.gas_names == ("h2o", "co2", "o3")
    assert kd.minor_lower.gas_names == ("h2o_slf", "h2o_frg")
    assert kd.minor_lower.kminor_start == (0, 4)
    assert kd.kminor_lower.shape[-1] == 8
    assert len(kd.minor_upper) == 0
    np.testing.assert_array_equal(kd.kminor_lower.numpy(),
                                  np.asarray(raw["kminor_lower"])[:, :, 4:12])


def test_missing_key_species_raises():
    with pytest.raises(ValueError, match="required gases"):
        KDist.from_raw(["h2o", "co2"], dtype=F64, device="cpu",
                       **synthetic_raw(sw=False))


def test_solar_source_total(kd_pair):
    np.testing.assert_allclose(float(kd_pair[True][1].solar_source.sum()),
                               1361.0, rtol=1e-10)


# ---------------------------------------------------------------------------
# the public API against the oracle
# ---------------------------------------------------------------------------

def test_tau_absorption_vs_oracle(kd_pair, atmos):
    jkd, kd = kd_pair[False]
    gas = GasOpticsRRTMGP(kd)
    a, t, gc = atmos
    props, _ = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"], t["tsfc"],
                                 gc, tlev=t["tlev"])
    col_gas, _ = _oracle_inputs(gas, atmos, gc)
    co = oracle_interpolation(jkd, a["play"], a["tlay"], col_gas)
    ref = oracle_tau_absorption(jkd, co, a["play"], a["tlay"], col_gas)
    np.testing.assert_allclose(props.tau.numpy(), ref, rtol=1e-10)
    assert np.all(ref > 0) and props.top_at_1


def test_tau_rayleigh_and_combine_vs_oracle(kd_pair, atmos):
    jkd, kd = kd_pair[True]
    gas = GasOpticsRRTMGP(kd)
    a, t, gc = atmos
    props, _ = gas.gas_optics_sw(t["play"], t["plev"], t["tlay"], gc)
    col_gas, col_dry = _oracle_inputs(gas, atmos, gc)
    co = oracle_interpolation(jkd, a["play"], a["tlay"], col_gas)
    ref_abs = oracle_tau_absorption(jkd, co, a["play"], a["tlay"], col_gas)
    ref_ray = oracle_tau_rayleigh(jkd, co, col_gas, col_dry)
    np.testing.assert_allclose(props.tau.numpy(), ref_abs + ref_ray,
                               rtol=1e-10)
    np.testing.assert_allclose(props.ssa.numpy(),
                               ref_ray / (ref_abs + ref_ray), rtol=1e-10)
    assert bool((props.g == 0).all())


def test_planck_sources_vs_oracle(kd_pair, atmos):
    jkd, kd = kd_pair[False]
    gas = GasOpticsRRTMGP(kd)
    a, t, gc = atmos
    _, src = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"], t["tsfc"],
                               gc, tlev=t["tlev"])
    col_gas, _ = _oracle_inputs(gas, atmos, gc)
    co = oracle_interpolation(jkd, a["play"], a["tlay"], col_gas)
    sfc, lay, lev, jac = oracle_planck(jkd, co, a["tlay"], a["tlev"],
                                       a["tsfc"], True)
    np.testing.assert_allclose(src.sfc_source.numpy(), sfc, rtol=1e-10)
    np.testing.assert_allclose(src.lay_source.numpy(), lay, rtol=1e-10)
    np.testing.assert_allclose(src.lev_source.numpy(), lev, rtol=1e-10)
    np.testing.assert_allclose(src.sfc_source_jac.numpy(), jac, rtol=1e-8)
    assert np.all(jac > 0)


def test_col_dry_physical(atmos):
    _, t, gc = atmos
    cd = get_col_dry(gc.get_vmr("h2o", 3, 7), t["plev"]).numpy()
    total = cd.sum(axis=1)
    assert np.all(cd > 0) and np.all((total > 1e25) & (total < 3e25))


def test_lw_end_to_end_with_solver(kd_pair, atmos):
    gas = GasOpticsRRTMGP(kd_pair[False][1])
    _, t, gc = atmos
    props, src = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"],
                                   t["tsfc"], gc, tlev=t["tlev"])
    f = rte_lw(props, src, np.ones((3, 1)), compute_jacobian=True)
    assert tuple(f.flux_up.shape) == (3, 8)
    assert bool((f.flux_up > 0).all()) and bool(torch.isfinite(f.flux_up).all())
    assert bool((f.flux_dn[:, 0] == 0).all())
    assert bool((f.flux_up_jac >= 0).all())


def test_lw_optimal_angles(kd_pair, atmos):
    gas = GasOpticsRRTMGP(kd_pair[False][1])
    _, t, gc = atmos
    props, src = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"],
                                   t["tsfc"], gc, tlev=t["tlev"])
    ds = gas.compute_optimal_angles(props)
    assert tuple(ds.shape) == (3, NGPT) and bool((ds > 1.0).all())
    f = rte_lw(props, src, np.ones((3, 1)), lw_ds=ds)
    assert bool(torch.isfinite(f.flux_up).all())


def test_sw_end_to_end_with_solver(kd_pair, atmos):
    gas = GasOpticsRRTMGP(kd_pair[True][1])
    _, t, gc = atmos
    props, toa = gas.gas_optics_sw(t["play"], t["plev"], t["tlay"], gc)
    np.testing.assert_allclose(toa.sum(-1).numpy(), 1361.0, rtol=1e-10)
    alb = np.full((3, 1), 0.15)
    f = rte_sw(props, np.full(3, 0.8), toa, alb, alb)
    np.testing.assert_allclose(f.flux_dn[:, 0].numpy(), 1361.0 * 0.8,
                               rtol=1e-10)
    assert bool((f.flux_up >= 0).all())
    assert np.all(np.diff(f.flux_dn_dir.numpy(), axis=1) <= 1e-10)


def test_tlev_interpolation_fallback(kd_pair, atmos):
    gas = GasOpticsRRTMGP(kd_pair[False][1])
    _, t, gc = atmos
    _, src = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"], t["tsfc"],
                               gc)
    assert bool(torch.isfinite(src.lev_source).all())


def test_orientation_invariance(kd_pair):
    gas = GasOpticsRRTMGP(kd_pair[False][1])
    t = lambda a: torch.as_tensor(np.array(a), dtype=F64)
    runs = []
    for top in (True, False):
        play, plev, tlay, tlev, tsfc, vmr = sample_atmosphere(top_at_1=top)
        props, src = gas.gas_optics_lw(t(play), t(plev), t(tlay), t(tsfc),
                                       port_gas(vmr), tlev=t(tlev))
        assert props.top_at_1 == top
        runs.append((props, rte_lw(props, src, np.ones((3, 1)))))
    (p1, f1), (p2, f2) = runs
    np.testing.assert_allclose(p1.tau.numpy(), p2.tau.numpy()[:, ::-1, :],
                               rtol=1e-12)
    np.testing.assert_allclose(f1.flux_up.numpy(),
                               f2.flux_up.numpy()[:, ::-1], rtol=1e-10)


def test_gas_optics_wrong_source_raises(kd_pair, atmos):
    _, t, gc = atmos
    with pytest.raises(ValueError, match="SW"):
        GasOpticsRRTMGP(kd_pair[True][1]).gas_optics_lw(
            t["play"], t["plev"], t["tlay"], t["tsfc"], gc)
    with pytest.raises(ValueError, match="LW"):
        GasOpticsRRTMGP(kd_pair[False][1]).gas_optics_sw(
            t["play"], t["plev"], t["tlay"], gc)


# ---------------------------------------------------------------------------
# the gather twins and the public API against the JAX package
# ---------------------------------------------------------------------------

SIZES = dict(ngpt=32, nbnd=4, ntemp=6, npres=12)
NCOL, NLAY = 128, 4
CASES = [("float64", False, 1e-12), ("float32", True, 1e-5)]
CASE_IDS = ["f64-xla", "f32-pallas-interpret"]


def both(sw, dtype):
    """The JAX and port gas optics on one table set, and the all-sky
    atmosphere (NCOL x NLAY) for both."""
    jkd = jax_kdist(sw=sw, dtype=getattr(jnp, dtype), **SIZES)
    tdt = getattr(torch, dtype)
    gas = GasOpticsRRTMGP(kdist_from_jax(jkd, dtype=tdt, device="cpu"))
    inp = jinputs(NCOL, NLAY, dtype=getattr(jnp, dtype))
    arr = {k: np.array(getattr(inp, k)) for k in ("play", "plev", "tlay",
                                                  "tlev", "tsfc")}
    gc = GasConcs.empty()
    for k in inp.gas_concs.names:
        gc = gc.set_vmr(k, np.asarray(inp.gas_concs.get_vmr(k, NCOL, NLAY)))
    t = {k: torch.as_tensor(v, dtype=tdt) for k, v in arr.items()}
    return JGasOptics(jkd), inp, gas, gc.to(dtype=tdt), t


def descriptors(jgas, inp, gas, gc, t):
    jcg, jdry, jh2o = jgas._col_gas(inp.play, inp.plev, inp.tlay,
                                    inp.gas_concs, None)
    jco = jgas._interp(inp.play, inp.tlay, jcg)
    cg, dry, h2o = gas.col_gas(t["play"], t["plev"], gc)
    co = gas.interp(t["play"], t["tlay"], cg)
    return (jco, jcg, jdry, jh2o), (co, cg, dry, h2o)


def close(got, ref, tol):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype,pallas,tol", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("sw", [False, True], ids=["lw", "sw"])
def test_gas_major_twin_matches_jax(sw, dtype, pallas, tol):
    jgas, inp, gas, gc, t = both(sw, dtype)
    (jco, *_), (co, *_) = descriptors(jgas, inp, gas, gc, t)
    jkd, kd = jgas.kdist, gas.kdist
    n0 = gas_major.launches
    tau, pf = gas_major(co, kd.kmajor, kd.planck_frac, gas.gpoint_flavor)
    assert gas_major.launches == n0
    band_lims = jkd.grid.band_lims_gpt_array
    if pallas:
        jtau, jpf = jpallas.tau_major_pallas(
            jco, jkd.kmajor_lane, neta=jkd.neta,
            gpoint_flavor=jkd.gpoint_flavor, band_lims_gpt=band_lims,
            ntab=jkd.kmajor_lane_ntab, interpret=True)
    else:
        jtau, jpf = jops.tau_major(jco, jkd.kmajor_x,
                                   gpoint_flavor=jkd.gpoint_flavor,
                                   band_lims_gpt=band_lims)
    close(tau, jtau, tol)
    assert (pf is None) == sw == (jpf is None)
    if not sw:
        close(pf, jpf, tol)


@pytest.mark.parametrize("sw", [False, True], ids=["lw", "sw"])
def test_gas_optics_major_call_matches_jax(sw):
    """The gas optics' call of the major gather (``_major``, with the
    interleaved LW table the kernel reads, ``GasOpticsRRTMGP.kmajor_pfrac``)
    on CPU tensors in float64 against the JAX package's ``tau_major``
    (XLA path) within 1e-12 of the largest value; the launch counter does
    not move."""
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import _major
    jgas, inp, gas, gc, t = both(sw, "float64")
    (jco, *_), (co, *_) = descriptors(jgas, inp, gas, gc, t)
    jkd, kd = jgas.kdist, gas.kdist
    assert (gas.kmajor_pfrac is None) == sw
    n0 = gas_major.launches
    tau, pf = _major(co, kd.kmajor, kd.planck_frac, gas.gpoint_flavor,
                     gas.kmajor_pfrac)
    assert gas_major.launches == n0
    jtau, jpf = jops.tau_major(jco, jkd.kmajor_x,
                               gpoint_flavor=jkd.gpoint_flavor,
                               band_lims_gpt=jkd.grid.band_lims_gpt_array)
    close(tau, jtau, 1e-12)
    assert (pf is None) == sw == (jpf is None)
    if not sw:
        close(pf, jpf, 1e-12)


@pytest.mark.parametrize("sw", [False, True], ids=["lw", "sw"])
def test_gas_major_wrapper_gathers_the_interleaved_table(sw, monkeypatch):
    """On the CUDA branch (taken here on CPU tensors, the launch replaced
    by a record of its arguments) the LW call hands the launcher the
    interleaved table (kmajor, planck_frac) in place of planck_frac, and
    raises without it, launching nothing; the SW call passes no table but
    kmajor. No table is built per launch."""
    from rte_rrtmgp_tpu_torch.ops.kernels import gas_major as gm
    calls = []
    monkeypatch.setattr(gm, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(gm, "launch", lambda *a: calls.append(a[3:]))
    _, inp, gas, gc, t = both(sw, "float32")
    co = gas.interp(t["play"], t["tlay"], gas.col_gas(t["play"], t["plev"],
                                                      gc)[0])
    kd = gas.kdist
    args = (co, kd.kmajor, kd.planck_frac, gas.gpoint_flavor)
    tau, pf = gm.gas_major(*args, gas.kmajor_pfrac)
    assert len(calls) == 1
    table = calls[0][9]
    if sw:
        assert table is None and pf is None
    else:
        kp = gas.kmajor_pfrac
        assert table.data_ptr() == kp.data_ptr()
        assert torch.equal(kp[..., 0], kd.kmajor)
        assert torch.equal(kp[..., 1], kd.planck_frac)
        assert not any(a is kd.planck_frac for a in calls[0])
        assert pf.shape == tau.shape == tuple(co.jtemp.shape) + (
            kd.kmajor.shape[3],)
        with pytest.raises(ValueError, match="kmajor_pfrac is missing"):
            gm.gas_major(*args)
        assert len(calls) == 1
    assert calls[0][8] is kd.kmajor


@pytest.mark.parametrize("dtype,pallas,tol", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_gas_minor_twin_matches_jax(lower, dtype, pallas, tol):
    jgas, inp, gas, gc, t = both(False, dtype)
    (jco, jcg, _, jh2o), (co, cg, _, h2o) = descriptors(jgas, inp, gas, gc,
                                                        t)
    jkd, kd = jgas.kdist, gas.kdist
    tau0 = np.random.default_rng(3).uniform(0.0, 2.0, (NCOL, NLAY, 32))
    mset = jkd.minor_lower if lower else jkd.minor_upper
    common = dict(lower=lower, minor_limits_gpt=mset.limits_gpt,
                  kminor_start=mset.kminor_start, idx_minor=mset.idx_minor,
                  idx_minor_scaling=mset.idx_minor_scaling,
                  minor_scales_with_density=mset.scales_with_density,
                  scale_by_complement=mset.scale_by_complement,
                  minor_flavor=mset.flavor, play=inp.play, tlay=inp.tlay,
                  col_gas=jcg, idx_h2o=jh2o)
    jtau0 = jnp.asarray(tau0, getattr(jnp, dtype))
    ktab_x = jkd.kminor_lower_x if lower else jkd.kminor_upper_x
    if pallas:
        ref = jpallas.tau_minor_pallas(
            jtau0, jco, jkd.kminor_lower_lane if lower
            else jkd.kminor_upper_lane, ntemp=jkd.temp_ref.shape[0],
            netam1=jkd.neta - 1, ncont=ktab_x.shape[-1], interpret=True,
            **common)
    else:
        ref = jops.tau_minor(jtau0, jco, ktab_x, **common)
    nlo = len(kd.minor_lower)
    minors = _split_minors(gas.minors)[0 if lower else 1]
    meta = gas.minor_meta[:nlo] if lower else gas.minor_meta[nlo:]
    scaling = minor_scaling(co, kd.minor_lower if lower else kd.minor_upper,
                            lower=lower, play=t["play"], tlay=t["tlay"],
                            col_gas=cg, idx_h2o=h2o)
    tau = torch.as_tensor(tau0, dtype=getattr(torch, dtype))
    n0 = gas_minor.launches
    out = gas_minor(tau, co, kd.kminor_lower if lower else kd.kminor_upper,
                    minors, meta, scaling)
    assert out is tau and gas_minor.launches == n0
    close(out, ref, tol)


@pytest.mark.parametrize("dtype,pallas,tol", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("scattering", [True, False], ids=["2str", "1scl"])
def test_gas_rayleigh_twin_matches_jax(scattering, dtype, pallas, tol):
    jgas, inp, gas, gc, t = both(True, dtype)
    (jco, jcg, jdry, jh2o), (co, cg, dry, h2o) = descriptors(jgas, inp, gas,
                                                             gc, t)
    jkd, kd = jgas.kdist, gas.kdist
    kw = dict(gpoint_flavor=jkd.gpoint_flavor,
              band_lims_gpt=jkd.grid.band_lims_gpt_array, col_gas=jcg,
              col_dry=jdry, idx_h2o=jh2o)
    if pallas:
        ray = jpallas.tau_rayleigh_pallas(
            jco, jkd.krayl_lane, ntemp=jkd.temp_ref.shape[0],
            netam1=jkd.neta - 1, interpret=True, **kw)
    else:
        ray = jops.tau_rayleigh(jco, jkd.krayl_x, **kw)
    tau0 = np.random.default_rng(4).uniform(0.0, 0.1, (NCOL, NLAY, 32))
    ray = np.asarray(ray, np.float64)
    ref_tau = tau0 + ray
    tau = torch.as_tensor(tau0, dtype=getattr(torch, dtype))
    n0 = gas_rayleigh.launches
    out, ssa = gas_rayleigh(tau, co, kd.krayl, gas.gpoint_flavor,
                            cg[h2o] + dry, scattering)
    assert out is tau and gas_rayleigh.launches == n0
    close(out, ref_tau, tol)
    if scattering:
        close(ssa, ray / ref_tau, tol)
    else:
        assert ssa is None


@pytest.mark.parametrize("dtype,pallas,tol", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("sw", [False, True], ids=["lw", "sw"])
def test_public_gas_optics_matches_jax(sw, dtype, pallas, tol):
    """gas_optics_lw/sw as a whole: optical depths (and ssa), sources."""
    jgas, inp, gas, gc, t = both(sw, dtype)
    set_use_pallas(pallas)
    try:
        if sw:
            jprops, jtoa = jgas.gas_optics_sw(inp.play, inp.plev, inp.tlay,
                                              inp.gas_concs, top_at_1=True)
        else:
            jprops, jsrc = jgas.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                              inp.tsfc, inp.gas_concs,
                                              tlev=inp.tlev, top_at_1=True)
    finally:
        set_use_pallas(None)
    if sw:
        props, toa = gas.gas_optics_sw(t["play"], t["plev"], t["tlay"], gc,
                                       top_at_1=True)
        close(props.ssa, jprops.ssa, tol)
        close(toa, jtoa, tol)
    else:
        props, src = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"],
                                       t["tsfc"], gc, tlev=t["tlev"],
                                       top_at_1=True)
        for f in ("lay_source", "lev_source", "sfc_source", "sfc_source_jac"):
            close(getattr(src, f), getattr(jsrc, f), tol)
    close(props.tau, jprops.tau, tol)
