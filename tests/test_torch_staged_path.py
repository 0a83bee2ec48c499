"""The staged lane-layout branch as a whole (``drivers/allsky.
allsky_staged_lw/sw``), its gas optics (``gas_optics_lw/sw_lanes``), and
the aerosols and clear-sky configurations of all three paths.

  * ``gas_optics_lw_lanes`` / ``gas_optics_sw_lanes`` stage by stage
    against the JAX package's under ``set_use_pallas(True)`` (its Pallas
    gathers in interpret mode), float64, on 128 x 6 all-sky cells (128
    columns, so the major kernel's pressure-window guard passes): optical
    depths, Planck fraction, band Planck values, the lane sources, the
    Rayleigh ssa or the split Rayleigh depth, the TOA flux; bound 1e-12
    of the largest value.
  * The staged path against the JAX package's staged branch
    (``allsky_step_lw_lanes`` / ``allsky_step_sw_lanes``), float64, for
    clouds x aerosols, LW and SW, on a banded k-distribution (32 g-points
    in 4 bands: the solvers that form the sources or the combine
    themselves) and a non-banded one (16 in 4); bound rtol 3e-5 /
    atol 5e-4 W/m2, the JAX package's fused-vs-generic bound
    (tests/test_pallas_gas_optics.py:275). The JAX branch is reached with
    a banded k-distribution through a test-side proxy of its gas optics
    without the fused solves.
  * The slice gate: the float64 twins of the fused, staged and public-API
    paths with aerosols within 7e-4 W/m2 (tests/test_golden_regression.py
    :22) of tests/golden/allsky.npz's ``lw_aer_*`` / ``sw_aer_*``, and the
    staged path without aerosols of its ``lw_*`` / ``sw_*``.
  * float32 on the CPU: the aerosols and clear-sky configurations on the
    staged and public-API paths against the fused path within the same
    rtol 3e-5 / atol 5e-4 W/m2; on CPU tensors no kernel is launched.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.drivers import allsky as jallsky  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_aerosol_optics as jax_aerosol,
    synthetic_cloud_optics as jax_cloud, synthetic_kdist as jax_kdist)
from rte_rrtmgp_tpu_torch.drivers import allsky  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_staged_lw, allsky_staged_sw,
    allsky_step_lw, allsky_step_sw, build_allsky, build_allsky_step)
from rte_rrtmgp_tpu_torch.ops.kernels import (  # noqa: E402
    fused_lw, fused_sw, solver_lanes)

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "allsky.npz")
DP_THRESHOLD = 7.0e-4
# (ncol, nlay, ngpt_lw, nbnd_lw, ngpt_sw, nbnd_sw, ntemp, npres)
KDISTS = {"banded": (128, 6, 32, 4, 32, 4, 6, 12),
          "nonbanded": (128, 6, 16, 4, 16, 4, 6, 12)}
GOLDEN_DIMS = (12, 24, 32, 4, 32, 4, 6, 12)
PATH_RTOL, PATH_ATOL = 3e-5, 5e-4
PATHS = {"fused": (allsky_step_lw, allsky_step_sw),
         "staged": (allsky_staged_lw, allsky_staged_sw),
         "api": (allsky_api_lw, allsky_api_sw)}


class NoFusedSolve:
    """The JAX gas optics without ``lw_fused_solve`` / ``sw_fused_solve``,
    so that the JAX driver takes its staged branch."""

    def __init__(self, gas):
        self._gas = gas

    def __getattr__(self, name):
        if name in ("lw_fused_solve", "sw_fused_solve"):
            raise AttributeError(name)
        return getattr(self._gas, name)


def jax_problem(dims):
    """The JAX package's objects for the port's build_allsky(dims, f64)."""
    ncol, nlay, ngl, nbl, ngs, nbs, ntemp, npres = dims
    kw = dict(ntemp=ntemp, npres=npres, dtype=jnp.float64)
    kd_lw = jax_kdist(sw=False, ngpt=ngl, nbnd=nbl, **kw)
    kd_sw = jax_kdist(sw=True, ngpt=ngs, nbnd=nbs, **kw)
    tab = lambda make, n, kd: make(
        nbnd=n, band_lims_wvn=kd.grid.band_lims_wvn_array,
        dtype=jnp.float64)
    cld_lw, cld_sw = tab(jax_cloud, nbl, kd_lw), tab(jax_cloud, nbs, kd_sw)
    inp = jallsky.make_allsky_inputs(ncol, nlay, cloud_optics=cld_lw,
                                     dtype=jnp.float64)
    return dict(gas_lw=JGasOptics(kd_lw), gas_sw=JGasOptics(kd_sw),
                cld_lw=cld_lw, cld_sw=cld_sw,
                aer_lw=tab(jax_aerosol, nbl, kd_lw),
                aer_sw=tab(jax_aerosol, nbs, kd_sw), inputs=inp)


@pytest.fixture(scope="module")
def problems():
    return {k: (build_allsky(*d, device="cpu", dtype=F64, use_aerosols=True),
                jax_problem(d)) for k, d in KDISTS.items()}


def close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, tol * np.abs(ref).max())


@pytest.mark.parametrize("banded", [False, True],
                         ids=["sources", "banded-planck"])
def test_gas_optics_lw_lanes_matches_jax(problems, banded):
    p, j = problems["banded"]
    ji, i = j["inputs"], p.inputs
    set_use_pallas(True)
    try:
        ref = j["gas_lw"].gas_optics_lw_lanes(
            ji.play, ji.plev, ji.tlay, ji.tsfc, ji.gas_concs, tlev=ji.tlev,
            banded_planck=banded)
    finally:
        set_use_pallas(None)
    got = p.gas_lw.gas_optics_lw_lanes(i.play, i.plev, i.tlay, i.tsfc,
                                       i.gas_concs, tlev=i.tlev,
                                       banded_planck=banded)
    close(got[0], ref[0])
    if banded:
        close(got[1], ref[1])
        for g, r in zip(got[2], ref[2]):
            close(g, r)
    else:
        for g, r in zip(got[1], ref[1]):
            close(g, r)


@pytest.mark.parametrize("split", [False, True], ids=["ssa", "split"])
def test_gas_optics_sw_lanes_matches_jax(problems, split):
    p, j = problems["banded"]
    ji, i = j["inputs"], p.inputs
    set_use_pallas(True)
    try:
        ref = j["gas_sw"].gas_optics_sw_lanes(ji.play, ji.plev, ji.tlay,
                                              ji.gas_concs,
                                              split_rayleigh=split)
    finally:
        set_use_pallas(None)
    got = p.gas_sw.gas_optics_sw_lanes(i.play, i.plev, i.tlay, i.gas_concs,
                                       split_rayleigh=split)
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("aerosols", [False, True], ids=["noaer", "aer"])
@pytest.mark.parametrize("clouds", [False, True], ids=["clear", "cloud"])
@pytest.mark.parametrize("kdist", sorted(KDISTS))
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_staged_path_matches_jax_staged_branch(problems, band, kdist, clouds,
                                               aerosols):
    p, j = problems[kdist]
    assert allsky._banded(p.gas_lw) == (kdist == "banded")
    opts = dict(use_clouds=clouds, use_aerosols=aerosols)
    set_use_pallas(True)
    try:
        jstep = (jallsky.allsky_step_lw_lanes if band == "lw"
                 else jallsky.allsky_step_sw_lanes)
        ref = jstep(j["inputs"], NoFusedSolve(j[f"gas_{band}"]),
                    cloud_optics=j[f"cld_{band}"],
                    aerosol_optics=j[f"aer_{band}"], **opts)
    finally:
        set_use_pallas(None)
    assert ref is not None
    step = allsky_staged_lw if band == "lw" else allsky_staged_sw
    got = step(p.inputs, getattr(p, f"gas_{band}"),
               cloud_optics=getattr(p, f"cld_{band}"),
               aerosol_optics=getattr(p, f"aer_{band}"), **opts)
    names = ("flux_up", "flux_dn") + (("flux_dn_dir",) if band == "sw"
                                      else ())
    for n in names:
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   np.asarray(getattr(ref, n)),
                                   rtol=PATH_RTOL, atol=PATH_ATOL, err_msg=n)


@pytest.fixture(scope="module")
def golden_problem():
    return build_allsky(*GOLDEN_DIMS, device="cpu", dtype=F64,
                        use_aerosols=True)


@pytest.mark.parametrize("path,aerosols", [
    ("fused", True), ("staged", True), ("api", True), ("staged", False)],
    ids=["fused-aer", "staged-aer", "api-aer", "staged-noaer"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_paths_match_golden(golden_problem, band, path, aerosols):
    p = golden_problem
    golden = np.load(GOLDEN)
    step = PATHS[path][0 if band == "lw" else 1]
    f = step(p.inputs, getattr(p, f"gas_{band}"),
             cloud_optics=getattr(p, f"cld_{band}"),
             aerosol_optics=getattr(p, f"aer_{band}"),
             use_aerosols=aerosols)
    key = f"{band}_aer_" if aerosols else f"{band}_"
    for n, k in (("flux_up", "up"), ("flux_dn", "dn")):
        v = getattr(f, n)
        assert v.dtype == F64 and v.shape == golden[key + k].shape
        d = float(np.abs(v.numpy() - golden[key + k]).max())
        assert d <= DP_THRESHOLD, f"{path} {key}{k}: {d:.3e} W/m2"


COUNTERS = (solver_lanes.lw_noscat_lanes, solver_lanes.lw_noscat_lanes_pfrac,
            solver_lanes.sw_2stream_lanes,
            solver_lanes.sw_2stream_lanes_combined, fused_lw.lw_fused,
            fused_sw.sw_fused)


@pytest.mark.parametrize("config", ["aerosols", "clear-sky"])
@pytest.mark.parametrize("path", ["staged", "api"])
@pytest.mark.parametrize("kdist", sorted(KDISTS))
def test_configs_match_fused_path_float32(kdist, path, config):
    """The float32 twins of each path against the fused path's, same
    inputs; no kernel launched on CPU tensors."""
    p = build_allsky(*KDISTS[kdist], device="cpu", use_aerosols=True)
    opts = (dict(use_aerosols=True) if config == "aerosols"
            else dict(use_clouds=False))
    before = [c.launches for c in COUNTERS]
    for b, band in enumerate(("lw", "sw")):
        kw = dict(cloud_optics=getattr(p, f"cld_{band}"),
                  aerosol_optics=getattr(p, f"aer_{band}"), **opts)
        gas = getattr(p, f"gas_{band}")
        ref = PATHS["fused"][b](p.inputs, gas, **kw)
        got = PATHS[path][b](p.inputs, gas, **kw)
        names = ("flux_up", "flux_dn") + (("flux_dn_dir",) if band == "sw"
                                          else ())
        for n in names:
            assert getattr(got, n).dtype == torch.float32
            np.testing.assert_allclose(getattr(got, n).numpy(),
                                       getattr(ref, n).numpy(),
                                       rtol=PATH_RTOL, atol=PATH_ATOL,
                                       err_msg=f"{band} {n}")
    assert [c.launches for c in COUNTERS] == before


def test_build_allsky_step_aerosols_is_the_composed_step():
    dims = GOLDEN_DIMS
    step, inputs = build_allsky_step(*dims, device="cpu", dtype=F64,
                                     use_aerosols=True)
    p = build_allsky(*dims, device="cpu", dtype=F64, use_aerosols=True)
    lw = allsky_step_lw(inputs, p.gas_lw, cloud_optics=p.cld_lw,
                        aerosol_optics=p.aer_lw, use_aerosols=True)
    sw = allsky_step_sw(inputs, p.gas_sw, cloud_optics=p.cld_sw,
                        aerosol_optics=p.aer_sw, use_aerosols=True)
    for g, r in zip(step(inputs), (lw.flux_up, lw.flux_dn, sw.flux_up,
                                   sw.flux_dn, sw.flux_dn_dir)):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("step", [allsky_step_lw, allsky_staged_lw,
                                  allsky_step_sw, allsky_staged_sw],
                         ids=["fused-lw", "staged-lw", "fused-sw",
                              "staged-sw"])
def test_missing_optics_raise(golden_problem, step):
    p = golden_problem
    gas = p.gas_lw if step.__name__.endswith("lw") else p.gas_sw
    with pytest.raises(ValueError, match="aerosol_optics"):
        step(p.inputs, gas, cloud_optics=p.cld_lw, use_aerosols=True)
    with pytest.raises(ValueError, match="cloud_optics"):
        step(p.inputs, gas, use_clouds=True)


def test_banded_rule_is_the_jax_rule(golden_problem):
    """Uniform band width, a multiple of 8 (drivers/allsky.py:179-184)."""
    from dataclasses import replace
    gas = golden_problem.gas_lw
    assert allsky._banded(gas)
    for lims, want in ((((1, 16), (17, 32)), True),
                       (((1, 4), (5, 8)), False),
                       (((1, 8), (9, 24)), False)):
        proxy = type("G", (), {"grid": replace(gas.grid,
                                               band_lims_gpt=lims)})()
        assert allsky._banded(proxy) == want
