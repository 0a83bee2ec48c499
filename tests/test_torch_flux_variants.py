"""examples/flux_variants_torch.py, the port's solver-variant script, on
the CPU at 8 x 12 in float64: every field it writes to its netCDF file
against the JAX package's counterpart called directly (the calls of
examples/flux_variants.py, in float64 and on its XLA path), within 1e-10
of the field's largest value.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from scipy.io import netcdf_file  # noqa: E402

from rte_rrtmgp_tpu import rte_lw, rte_sw  # noqa: E402
from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP)
from rte_rrtmgp_tpu.utils.profiles import rcemip_profiles  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import synthetic_kdist  # noqa: E402

NCOL, NLAY = 8, 12
SCRIPT = os.path.join(os.path.dirname(__file__), "..", "examples",
                      "flux_variants_torch.py")


def jax_fields():
    """The JAX script's variants, float64, XLA path."""
    f64 = jnp.float64
    play, plev, tlay, tlev, _z, gas = rcemip_profiles(NCOL, NLAY)
    play, plev, tlay, tlev = (jnp.asarray(x, f64)
                              for x in (play, plev, tlay, tlev))
    tsfc = tlay[:, -1]
    emis = jnp.full((NCOL, 1), 0.98, f64)
    kw = dict(ntemp=14, npres=59, dtype=f64)
    gop = GasOpticsRRTMGP(synthetic_kdist(sw=False, ngpt=256, nbnd=16, **kw))
    out = {}

    def keep(suffix, f):
        out[f"lw_flux_up{suffix}"] = f.flux_up
        out[f"lw_flux_dn{suffix}"] = f.flux_dn

    props, src = gop.gas_optics_lw(play, plev, tlay, tsfc, gas, tlev=tlev,
                                   top_at_1=True)
    keep("", rte_lw(props, src, emis))
    props2, src2 = gop.gas_optics_lw(play, plev, tlay, tsfc, gas,
                                     top_at_1=True)
    keep("_notlev", rte_lw(props2, src2, emis))
    keep("_3ang", rte_lw(props, src, emis, n_gauss_angles=3))
    keep("_optang", rte_lw(props, src, emis,
                           lw_ds=gop.compute_optimal_angles(props)))
    f = rte_lw(props, src, emis, compute_jacobian=True)
    keep("_jaco", f)
    out["lw_jaco_up"] = f.flux_up_jac
    props_2s, src_2s = gop.gas_optics_lw(play, plev, tlay, tsfc, gas,
                                         tlev=tlev, scattering=True,
                                         top_at_1=True)
    keep("_2str", rte_lw(props_2s, src_2s, emis, use_2stream=True))
    gsw = GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=224, nbnd=14, **kw))
    p_sw, toa = gsw.gas_optics_sw(play, plev, tlay, gas, top_at_1=True)
    alb = jnp.full((NCOL, 1), 0.06, f64)
    f = rte_sw(p_sw, jnp.full((NCOL,), 0.86, f64), toa, alb, alb)
    out["sw_flux_up"] = f.flux_up
    out["sw_flux_dn"] = f.flux_dn
    out["sw_flux_dir"] = f.flux_dn_dir
    return {k: np.asarray(v) for k, v in out.items()}


def test_flux_variants_script_matches_jax(tmp_path):
    spec = importlib.util.spec_from_file_location("flux_variants_torch",
                                                  SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "variants.nc"
    script.main(["--ncol", str(NCOL), "--nlay", str(NLAY), "--device", "cpu",
                 "--dtype", "float64", "--out", str(out)])
    set_use_pallas(False)
    try:
        ref = jax_fields()
    finally:
        set_use_pallas(None)
    with netcdf_file(str(out), "r", mmap=False) as nc:
        got = {k: np.array(v[:]) for k, v in nc.variables.items()}
    assert sorted(got) == sorted(ref) and len(got) == 16
    for k, r in ref.items():
        assert got[k].shape == r.shape == (NCOL, NLAY + 1), k
        np.testing.assert_allclose(got[k], r, rtol=0,
                                   atol=1e-10 * np.abs(r).max(), err_msg=k)
    # the Jacobian does not change the fluxes, and two-stream differs
    np.testing.assert_array_equal(got["lw_flux_up_jaco"], got["lw_flux_up"])
    assert not np.allclose(got["lw_flux_up_2str"], got["lw_flux_up"])
