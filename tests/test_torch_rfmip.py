"""The port's RFMIP clear-sky drivers, its gas store's subsets and its
field comparison, against the JAX package on the CPU.

  * The cases of tests/test_rfmip.py, one for one, on the same synthetic
    problem (6 sites x 20 layers x 3 experiments, 32 g-points in 4 bands)
    and with the same bounds: blocked equals unblocked (rtol 2e-6 / atol
    1e-5), night columns zero and TOA SW down = TSI mu0 by day (rtol
    1e-4), combined equals split, the netCDF round trip through
    ``compare_fields``, RFMIP through SSM.
  * ``synthetic_rfmip`` equal to the JAX one field by field.
  * In float64 both routes, the fused kernels' twins (the wrappers
    recorded, so the route is shown to be taken) and the generic route
    (``fused_ok=False``: gathers and public solvers), within 7e-4 W/m2 of
    tests/golden/rfmip.npz (the DP gate, test_golden_regression.py:22),
    given top first and bottom first (every layer field reversed; the
    bottom-first fluxes reversed equal the top-first ones within 1e-9 of
    the largest flux).
  * RFMIP through SSM against the JAX package's in float64 (1e-10 of the
    largest flux); ``device_inputs`` keyed by device and dtype.
  * ``GasConcs.gas_names`` and ``get_subset`` against the JAX package's;
    ``compare_fields`` with and without the environment overrides.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu.drivers import rfmip as jrfmip  # noqa: E402
from rte_rrtmgp_tpu.gas_concs import GasConcs as JGasConcs  # noqa: E402
from rte_rrtmgp_tpu.models import ssm as jssm  # noqa: E402
from rte_rrtmgp_tpu_torch.convert import gas_concs_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers import rfmip  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.rfmip import (  # noqa: E402
    determine_gas_names, rfmip_lw, rfmip_lw_sw, rfmip_sw, synthetic_rfmip,
    unblock, write_fluxes)
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp import gas_optics as gas_mod  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP)
from rte_rrtmgp_tpu_torch.models.ssm import (ssm_lw_defaults,  # noqa: E402
                                             ssm_sw_defaults)
from rte_rrtmgp_tpu_torch.utils.compare import (  # noqa: E402
    compare_fields, default_failure_threshold)
from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist  # noqa: E402

NSITE, NLAY, NEXP = 6, 20, 3
DP_THRESHOLD = 7.0e-4
GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "rfmip.npz"))
KD = dict(ngpt=32, nbnd=4, ntemp=6, npres=12, device="cpu")


@pytest.fixture(scope="module")
def data():
    return synthetic_rfmip(NSITE, NLAY, NEXP)


@pytest.fixture(scope="module")
def gas_lw():
    return GasOpticsRRTMGP(synthetic_kdist(sw=False, **KD))


@pytest.fixture(scope="module")
def gas_sw():
    return GasOpticsRRTMGP(synthetic_kdist(sw=True, **KD))


@pytest.fixture(scope="module")
def f64():
    """The golden's problem in float64: data and both providers."""
    kd = dict(KD, dtype=torch.float64)
    return (synthetic_rfmip(NSITE, NLAY, NEXP, dtype=np.float64),
            GasOpticsRRTMGP(synthetic_kdist(sw=False, **kd)),
            GasOpticsRRTMGP(synthetic_kdist(sw=True, **kd)))


def test_determine_gas_names():
    kd, fl = determine_gas_names(("h2o", "co2", "o3", "n2o"), 1)
    assert kd == ("h2o", "co2", "o3", "n2o")
    assert fl == ("h2o", "carbon_dioxide", "o3", "nitrous_oxide")
    kd2, fl2 = determine_gas_names((), 2)
    assert "cfc11" in kd2 and "cfc11eq" in fl2
    with pytest.raises(ValueError):
        determine_gas_names((), 4)
    for names, index in ((("h2o", "CO2", "cfc22"), 1), ((), 2), ((), 3)):
        assert determine_gas_names(names, index) == \
            jrfmip.determine_gas_names(names, index)


def test_rfmip_lw_blocked_equals_unblocked(data, gas_lw):
    up_all, dn_all = rfmip_lw(data, gas_lw)
    up_blk, dn_blk = rfmip_lw(data, gas_lw, block_size=NSITE)
    assert up_all.shape == (NSITE * NEXP, NLAY + 1)
    np.testing.assert_allclose(up_blk, up_all, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(dn_blk, dn_all, rtol=2e-6, atol=1e-5)
    assert np.all(np.isfinite(up_all)) and np.all(up_all > 0)
    olr = unblock(data, up_all)[:, :, 0].mean(axis=1)
    assert olr.std() > 1e-3
    with pytest.raises(ValueError, match="evenly"):
        rfmip_lw(data, gas_lw, block_size=NSITE + 1)


def test_rfmip_sw_nighttime_zeroed(data, gas_sw):
    up, dn = rfmip_sw(data, gas_sw)
    night = np.asarray(data.sza) >= 90.0 - 2e-5
    assert night.any() and (~night).any()
    assert np.all(up[night] == 0.0) and np.all(dn[night] == 0.0)
    assert np.all(up[~night] >= 0.0)
    mu0 = np.cos(np.deg2rad(data.sza[~night]))
    np.testing.assert_allclose(dn[~night][:, 0], data.tsi[~night] * mu0,
                               rtol=1e-4)


def test_rfmip_lw_sw_combined_equals_split(data, gas_lw, gas_sw):
    rlu, rld, rsu, rsd = rfmip_lw_sw(data, gas_lw, gas_sw)
    lu, ld = rfmip_lw(data, gas_lw)
    su, sd = rfmip_sw(data, gas_sw)
    for a, b in zip((rlu, rld, rsu, rsd), (lu, ld, su, sd)):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-5)
    blk = rfmip_lw_sw(data, gas_lw, gas_sw, block_size=NSITE)
    for a, b in zip(blk, (rlu, rld, rsu, rsd)):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-5)
    dev = rfmip_lw_sw(data, gas_lw, gas_sw, device_out=True)
    assert isinstance(dev, torch.Tensor)
    assert tuple(dev.shape) == (4, NSITE * NEXP, NLAY + 1)
    np.testing.assert_array_equal(dev.numpy(), np.stack(
        (rlu, rld, rsu, rsd)))
    with pytest.raises(ValueError, match="device_out"):
        rfmip_lw_sw(data, gas_lw, gas_sw, device_out=True, block_size=NSITE)


def test_write_and_compare_roundtrip(tmp_path, data, gas_lw):
    up, _ = rfmip_lw(data, gas_lw)
    p = str(tmp_path / "rlu.nc")
    write_fluxes(p, "rlu", data, up)
    from scipy.io import netcdf_file
    with netcdf_file(p, "r") as f:
        back = np.array(f.variables["rlu"][:])
    assert back.shape == (NEXP, NSITE, NLAY + 1)
    np.testing.assert_allclose(back, unblock(data, up), rtol=1e-6)
    assert compare_fields(back, unblock(data, up), "rlu",
                          failure_threshold=3.5e-1)
    assert not compare_fields(back + 1.0, unblock(data, up), "rlu",
                              failure_threshold=3.5e-1, verbose=False)


def test_rfmip_with_ssm_scheme(data):
    up, dn = rfmip_lw(data, ssm_lw_defaults(device="cpu"))
    assert up.shape == (NSITE * NEXP, NLAY + 1)
    assert np.all(np.isfinite(up)) and np.all(up > 0)
    su, sd = rfmip_sw(data, ssm_sw_defaults(device="cpu"))
    assert np.all(np.isfinite(su))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_rfmip_matches_jax(dtype):
    got = synthetic_rfmip(NSITE, NLAY, NEXP, dtype=dtype)
    ref = jrfmip.synthetic_rfmip(NSITE, NLAY, NEXP, dtype=dtype)
    assert (got.nsite, got.nexp, got.ncol, got.nlay) == \
        (ref.nsite, ref.nexp, ref.ncol, ref.nlay)
    for f in rfmip._FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype == dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.gas_concs.gas_names == ref.gas_concs.gas_names
    for name in ref.gas_concs.gas_names:
        np.testing.assert_array_equal(
            got.gas_concs.get_vmr(name, got.ncol, got.nlay).numpy(),
            np.asarray(ref.gas_concs.get_vmr(name, ref.ncol, ref.nlay)),
            err_msg=name)


def _bottom_first(d):
    """The same problem with every layer field reversed."""
    return dataclasses.replace(
        d, **{f: np.ascontiguousarray(getattr(d, f)[:, ::-1])
              for f in ("play", "plev", "tlay", "tlev")},
        gas_concs=rfmip._flip_lay(d.gas_concs))


class _Recorder:
    """A kernel wrapper that counts its calls and calls through."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("orientation", ["top", "bottom"])
@pytest.mark.parametrize("route", ["fused", "generic"])
def test_rfmip_golden_f64(f64, monkeypatch, route, orientation):
    data, g_lw, g_sw = f64
    if orientation == "bottom":
        data = _bottom_first(data)
    top_at_1 = rfmip._top_at_1(data)
    assert top_at_1 == (orientation == "top")
    rec = {k: _Recorder(getattr(gas_mod, k)) for k in ("lw_fused",
                                                       "sw_fused")}
    for k, r in rec.items():
        monkeypatch.setattr(gas_mod, k, r)
    if route == "fused":
        lu, ld = rfmip_lw(data, g_lw)
        su, sd = rfmip_sw(data, g_sw)
        assert rec["lw_fused"].calls == 1 and rec["sw_fused"].calls == 1
    else:
        x = rfmip._inputs(data, g_lw)
        lu, ld = (f.numpy() for f in rfmip._lw_compute(
            g_lw, top_at_1, False, 1)(*rfmip._lw_args(x)))
        su, sd = (f.numpy() for f in rfmip._sw_compute(
            g_sw, top_at_1, False)(*rfmip._sw_args(x)))
        assert rec["lw_fused"].calls == 0 and rec["sw_fused"].calls == 0
    got = dict(lw_up=lu, lw_dn=ld, sw_up=su, sw_dn=sd)
    if orientation == "bottom":
        top = dict(zip(got, rfmip_lw(f64[0], g_lw) + rfmip_sw(f64[0], g_sw)))
        got = {k: v[:, ::-1] for k, v in got.items()}
        for k, v in got.items():
            np.testing.assert_allclose(v, top[k], rtol=0,
                                       atol=1e-9 * np.abs(top[k]).max(),
                                       err_msg=k)
    for k, v in got.items():
        d = float(np.abs(v - GOLDEN[k]).max())
        assert d <= DP_THRESHOLD, (k, d)


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_rfmip_ssm_matches_jax(band):
    data = synthetic_rfmip(NSITE, NLAY, NEXP, dtype=np.float64)
    jdata = jrfmip.synthetic_rfmip(NSITE, NLAY, NEXP, dtype=np.float64)
    if band == "lw":
        got = rfmip_lw(data, ssm_lw_defaults(device="cpu"))
        ref = jrfmip.rfmip_lw(jdata, jssm.ssm_lw_defaults())
    else:
        got = rfmip_sw(data, ssm_sw_defaults(device="cpu"))
        ref = jrfmip.rfmip_sw(jdata, jssm.ssm_sw_defaults())
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())


def test_device_inputs_keyed(data):
    f32 = data.device_inputs("cpu", torch.float32)
    f64 = data.device_inputs("cpu", torch.float64)
    assert f32 is data.device_inputs(torch.device("cpu"), torch.float32)
    assert f32["play"].dtype == torch.float32
    assert f64["play"].dtype == torch.float64
    assert all(v.dtype == torch.float64 for v in f64["gas_concs"].values)
    meta = data.device_inputs("meta", torch.float32)
    assert meta is not f32 and meta["tlev"].device.type == "meta"
    assert all(v.device.type == "meta" for v in meta["gas_concs"].values)
    np.testing.assert_array_equal(f64["sza"].numpy(), data.sza)


def test_gas_concs_names_and_subset():
    rng = np.random.default_rng(3)
    field = rng.uniform(0.0, 1e-2, (6, 5))
    prof = rng.uniform(0.0, 1e-3, 5)
    jgc = (JGasConcs.empty().set_vmr("H2O", field).set_vmr("co2", 4e-4)
           .set_vmr("o3", prof))
    gc = gas_concs_from_jax(jgc, device="cpu")
    assert gc.gas_names == jgc.gas_names == ("h2o", "co2", "o3")
    sub, jsub = gc.get_subset(2, 3), jgc.get_subset(2, 3)
    assert sub.gas_names == jsub.gas_names
    for name in jsub.gas_names:
        np.testing.assert_array_equal(sub.get_vmr(name, 3, 5).numpy(),
                                      np.asarray(jsub.get_vmr(name, 3, 5)))
    # scalars and profiles pass through, untouched
    assert sub.values[1] is gc.values[1] and sub.values[2] is gc.values[2]
    assert tuple(sub.values[0].shape) == (3, 5)
    own = GasConcs.empty().set_vmr("h2o", torch.from_numpy(field))
    np.testing.assert_array_equal(own.get_subset(1, 2).values[0].numpy(),
                                  field[1:3])


def test_compare_fields_thresholds(monkeypatch, capsys):
    monkeypatch.delenv("FAILURE_THRESHOLD", raising=False)
    monkeypatch.delenv("REPORTING_THRESHOLD", raising=False)
    ref = np.zeros((2, 3))
    assert default_failure_threshold() == 3.5e-1
    assert default_failure_threshold(double_precision=True) == 7.0e-4
    assert compare_fields(ref + 0.3, ref, "x")
    assert not compare_fields(ref + 0.4, ref, "x")
    assert "FAIL" in capsys.readouterr().out
    assert compare_fields(ref + 1e-4, ref, "x", failure_threshold=7e-4)
    monkeypatch.setenv("FAILURE_THRESHOLD", "1e-5")
    assert default_failure_threshold(double_precision=True) == 1e-5
    assert not compare_fields(ref + 1e-4, ref, "x")
    capsys.readouterr()
    monkeypatch.setenv("REPORTING_THRESHOLD", "1.0")
    assert compare_fields(ref + 1e-6, ref, "x")
    assert capsys.readouterr().out == ""
    from rte_rrtmgp_tpu.utils.compare import compare_fields as jcompare
    for d in (1e-6, 1e-4, 0.2):
        assert compare_fields(ref + d, ref, verbose=False) == \
            jcompare(ref + d, ref, verbose=False)
