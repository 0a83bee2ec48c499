"""The port's tables and inputs equal the JAX package's.

The port's own generators (utils/synthetic.py, utils/profiles.py,
KDist.from_raw, CloudOpticsRRTMGP.load, make_allsky_inputs) and its
converter (convert.py) must produce exactly the arrays of the JAX
package's KDist, CloudOpticsRRTMGP and make_allsky_inputs. Float64
throughout, where both packages only copy or reorder the same numpy data:
equality is exact except for the solar source, which both compute in the
working dtype (summation order may differ: rtol 1e-14).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.drivers.allsky import make_allsky_inputs as jax_inputs  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics as jax_cloud, synthetic_kdist as jax_kdist)
from rte_rrtmgp_tpu_torch.convert import (cloud_optics_from_jax,  # noqa: E402
                                          kdist_from_jax)
from rte_rrtmgp_tpu_torch.drivers.allsky import make_allsky_inputs  # noqa: E402
from rte_rrtmgp_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics, synthetic_kdist)

SIZES = dict(ngpt=32, nbnd=4, ntemp=5, npres=10)

_TABLES = ("kmajor", "kminor_lower", "kminor_upper", "krayl", "planck_frac",
           "totplnk")
_META = ("gas_names", "press_ref_trop_log", "press_ref_log_delta",
         "temp_ref_min", "temp_ref_delta", "temp_ref_max", "neta",
         "totplnk_delta", "minor_lower", "minor_upper")


def _same_kdist(port, ref):
    for name in _TABLES:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for name in ("flavor", "gpoint_flavor", "press_ref_log", "temp_ref",
                 "vmr_ref"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in _META:
        assert (getattr(port, name) == getattr(ref, name)
                if not name.startswith("minor") else
                vars(getattr(port, name)) == vars(getattr(ref, name))), name
    assert port.grid.band_lims_gpt == ref.grid.band_lims_gpt
    assert port.grid.band_lims_wvn == ref.grid.band_lims_wvn
    if ref.solar_source is None:
        assert port.solar_source is None
    else:
        np.testing.assert_allclose(port.solar_source.numpy(),
                                   np.asarray(ref.solar_source), rtol=1e-14)


@pytest.mark.parametrize("sw", [False, True], ids=["lw", "sw"])
@pytest.mark.parametrize("route", ["generator", "convert"])
def test_kdist_equals_jax(sw, route):
    ref = jax_kdist(sw=sw, dtype=jnp.float64, **SIZES)
    port = (synthetic_kdist(sw=sw, dtype=torch.float64, device="cpu",
                            **SIZES)
            if route == "generator"
            else kdist_from_jax(ref, dtype=torch.float64, device="cpu"))
    _same_kdist(port, ref)


@pytest.mark.parametrize("route", ["generator", "convert"])
def test_cloud_tables_equal_jax(route):
    ref = jax_cloud(nbnd=4, dtype=jnp.float64)
    port = (synthetic_cloud_optics(nbnd=4, dtype=torch.float64, device="cpu")
            if route == "generator"
            else cloud_optics_from_jax(ref, dtype=torch.float64,
                                      device="cpu"))
    for name in ("extliq", "ssaliq", "asyliq", "extice", "ssaice", "asyice"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("radliq_lwr", "radliq_upr", "diamice_lwr", "diamice_upr",
                 "icergh"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.grid.band_lims_wvn == ref.grid.band_lims_wvn


@pytest.mark.parametrize("ncol,nlay", [(8, 8), (12, 24)])
def test_allsky_inputs_equal_jax(ncol, nlay):
    cld_ref = jax_cloud(nbnd=4, dtype=jnp.float64)
    ref = jax_inputs(ncol, nlay, cloud_optics=cld_ref, dtype=jnp.float64)
    port = make_allsky_inputs(ncol, nlay,
                              cloud_optics=synthetic_cloud_optics(
                                  nbnd=4, dtype=torch.float64, device="cpu"),
                              dtype=torch.float64, device="cpu")
    for name in ref._fields:
        if name == "gas_concs":
            continue
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert port.gas_concs.names == ref.gas_concs.names
    for g in ref.gas_concs.names:
        np.testing.assert_array_equal(
            port.gas_concs.get_vmr(g, ncol, nlay).numpy(),
            np.asarray(ref.gas_concs.get_vmr(g, ncol, nlay)), g)


def test_gas_concs_checks():
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    gas = GasConcs.empty().set_vmr("H2O", np.full(3, 0.01)).set_vmr("co2", 4e-4)
    assert "h2o" in gas and gas.get_vmr("CO2", 2, 3).shape == (2, 3)
    with pytest.raises(ValueError):
        gas.set_vmr("o3", 1.5)
    with pytest.raises(ValueError):
        gas.get_vmr("h2o", 2, 4)
    with pytest.raises(KeyError):
        gas.get_vmr("ch4", 2, 3)
