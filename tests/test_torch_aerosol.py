"""The port's MERRA aerosol optics against the JAX package's.

  * The synthetic tables (``synthetic_aerosol_optics``, seed 0) and the
    tables carried across by ``convert.aerosol_optics_from_jax`` equal the
    JAX object's, value for value.
  * ``aerosol_optics`` (1scl and 2str) and ``aerosol_optics_lanes`` on the
    same numpy-seeded cells, float64, within 1e-12 relative: every type
    code 0-7 plus an unknown one (8), sizes inside every bin and on its
    edges, relative humidity on the grid points, between them, and at 0
    and 1.
  * The range checks raise where the JAX package's do (an active cell
    with its size outside the bin table or its RH outside [0, 1]), stay
    quiet on inactive cells, and are skipped under ``checks_disabled``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import checks_disabled as jchecks_off  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_aerosol_optics as jax_aerosol)
from rte_rrtmgp_tpu_torch.config import checks_disabled  # noqa: E402
from rte_rrtmgp_tpu_torch.convert import aerosol_optics_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_aerosol_optics)

F64 = torch.float64
TABLES = ("dust_tbl", "salt_tbl", "sulf_tbl", "bcar_tbl", "bcar_rh_tbl",
          "ocar_tbl", "ocar_rh_tbl")
NBND = 5


@pytest.fixture(scope="module")
def pair():
    return (jax_aerosol(nbnd=NBND, dtype=jnp.float64),
            synthetic_aerosol_optics(nbnd=NBND, dtype=F64, device="cpu"))


def cells(jaer):
    """(type, size, mass, rh), (9, 12): each type code 0-8 in its own
    row; sizes inside the bins and on their edges; RH on the grid, between
    grid points, at 0 and 1."""
    rng = np.random.default_rng(7)
    ncol, nlay = 9, 12
    atype = np.repeat(np.arange(ncol, dtype=np.int32)[:, None], nlay, 1)
    lims = np.asarray(jaer.bin_lims)
    edges = np.concatenate([lims[0], lims[1, -1:]])
    size = rng.uniform(lims[0, 0], lims[1, -1], (ncol, nlay))
    size[:, :len(edges)] = edges
    grid = np.asarray(jaer.aero_rh)
    rh = rng.uniform(0.0, 1.0, (ncol, nlay))
    rh[:, 0], rh[:, 1], rh[:, 2], rh[:, 3] = 0.0, 1.0, grid[5], grid[-1]
    rh[:, 4] = 0.5 * (grid[10] + grid[11])
    mass = rng.uniform(1e-7, 1e-4, (ncol, nlay))
    return atype, size, mass, rh


def test_tables_equal_jax(pair):
    jaer, aer = pair
    conv = aerosol_optics_from_jax(jaer, dtype=F64, device="cpu")
    for other in (aer, conv):
        for f in TABLES:
            np.testing.assert_array_equal(getattr(other, f).numpy(),
                                          np.asarray(getattr(jaer, f)))
        np.testing.assert_array_equal(other.bin_lims, jaer.bin_lims)
        np.testing.assert_array_equal(other.aero_rh, jaer.aero_rh)
        assert other.grid.band_lims_gpt == tuple(
            map(tuple, jaer.grid.band_lims_gpt))


def close(got, ref):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("form", ["1scl", "2str", "lanes"])
def test_aerosol_optics_matches_jax(pair, form):
    jaer, aer = pair
    arrs = cells(jaer)
    t = [torch.as_tensor(a) for a in arrs]
    if form == "lanes":
        for g, r in zip(aer.aerosol_optics_lanes(*t),
                        jaer.aerosol_optics_lanes(*arrs)):
            close(g, r)
        return
    sc = form == "2str"
    got = aer.aerosol_optics(*t, scattering=sc)
    ref = jaer.aerosol_optics(*arrs, scattering=sc)
    assert type(got).__name__ == type(ref).__name__
    for f in ("tau", "ssa", "g") if sc else ("tau",):
        close(getattr(got, f), getattr(ref, f))
    # no aerosol where the type is 0 or unknown, some where it is not
    tau = got.tau.numpy()
    assert (tau[0] == 0).all() and (tau[8] == 0).all()
    assert (tau[1:8] > 0).all()


@pytest.mark.parametrize("case", ["size_low", "size_high", "rh_low",
                                  "rh_high", "inactive"])
def test_range_checks_match_jax(pair, case):
    jaer, aer = pair
    atype, size, mass, rh = (a.copy() for a in cells(jaer))
    lims = np.asarray(jaer.bin_lims)
    row = 0 if case == "inactive" else 3
    if case in ("size_low", "inactive"):
        size[row, 5] = 0.5 * lims[0, 0]
    elif case == "size_high":
        size[row, 5] = 2.0 * lims[1, -1]
    elif case == "rh_low":
        rh[row, 5] = -0.01
    else:
        rh[row, 5] = 1.01
    t = [torch.as_tensor(a) for a in (atype, size, mass, rh)]
    if case == "inactive":
        jaer.aerosol_optics(atype, size, mass, rh)
        aer.aerosol_optics(*t)
        return
    match = "size" if case.startswith("size") else "humidity"
    with pytest.raises(ValueError, match=match):
        jaer.aerosol_optics(atype, size, mass, rh)
    with pytest.raises(ValueError, match=match):
        aer.aerosol_optics(*t)
    with checks_disabled(), jchecks_off():
        got = aer.aerosol_optics(*t)
        ref = jaer.aerosol_optics(atype, size, mass, rh)
    close(got.tau, ref.tau)
