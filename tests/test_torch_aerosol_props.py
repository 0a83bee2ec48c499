"""The aerosol lookup (``ops/kernels/aerosol_props``: the CUDA kernel's
plain twin, as ``AerosolOpticsMERRA`` calls it) and the fused all-sky step
with aerosols, against the benchmark's plain reference
(``torch_bench/reference/allsky_aer.py``, written from
mo_aerosol_optics_rrtmgp_merra.F90), float64 on the CPU:

  * the lookup's (tau, tau*ssa, tau*ssa*g) by band at 24 columns within
    1e-12 of the largest value: each type code 1-7, type 0 and an unknown
    code (8), sizes in every bin and on the bins' edges, relative
    humidity below the RH grid, on a grid point, between points and at
    1.0 (above the grid's last point);
  * the step's two increments in one launch: LW the aerosols' absorption
    plus the clouds', SW the delta-scaled aerosols combined with the
    delta-scaled clouds, against the reference's increments;
  * the fused all-sky step with aerosols against the reference at 24
    columns and the ``ne30pg2_aer`` configuration's widths, every flux
    within 1e-10 W/m2;
  * the gradient through the lookup (the twin's): gradcheck in the mass,
    the relative humidity and the clouds' lanes;
  * the range check reads both flags in one host read, and raises.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch import trace  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.aerosol_optics import (  # noqa: E402
    AerosolOpticsMERRA)
from rte_rrtmgp_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_aerosol_raw)
from torch_bench import harness  # noqa: E402
from torch_bench.reference import allsky_aer as ref  # noqa: E402

F64 = torch.float64
NCOL, NLAY, NBND = 24, 12, 5
# the RH grid starts above 0 so that some humidity lies below it
RH_GRID = np.linspace(0.1, 0.99, 37)
RH_CASES = ("below", "on_point", "between", "at_one")


@pytest.fixture(scope="module")
def tables():
    raw = synthetic_aerosol_raw(nbnd=NBND, seed=3)
    raw["aero_rh"] = RH_GRID
    return raw, AerosolOpticsMERRA.load(dtype=F64, device="cpu", **raw)


def cells(code, rh_case):
    """(type, size, mass, rh), each (NCOL, NLAY): every cell of type
    ``code``; sizes across the bins, the bins' edges among them."""
    g = np.random.default_rng(code * 10 + RH_CASES.index(rh_case))
    edges = np.logspace(-1, 1, 6)
    size = g.uniform(edges[0], edges[-1], (NCOL, NLAY))
    size[:, :6] = edges
    if rh_case == "below":
        rh = g.uniform(0.0, RH_GRID[0], (NCOL, NLAY))
    elif rh_case == "on_point":
        rh = RH_GRID[g.integers(0, len(RH_GRID), (NCOL, NLAY))]
    elif rh_case == "between":
        k = g.integers(0, len(RH_GRID) - 1, (NCOL, NLAY))
        rh = RH_GRID[k] + g.uniform(0.05, 0.95, (NCOL, NLAY)) * (
            RH_GRID[k + 1] - RH_GRID[k])
    else:
        rh = np.ones((NCOL, NLAY))
    atype = np.full((NCOL, NLAY), code, np.int32)
    mass = g.uniform(1e-7, 1e-4, (NCOL, NLAY))
    return tuple(torch.as_tensor(a) for a in (atype, size, mass, rh))


def close(got, want):
    scale = float(want.abs().max())
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == F64
    assert float((got - want).abs().max()) <= 1e-12 * max(scale, 1e-300)


@pytest.mark.parametrize("rh_case", RH_CASES)
@pytest.mark.parametrize("code", range(9))
def test_lookup_matches_reference(tables, code, rh_case):
    raw, aer = tables
    x = cells(code, rh_case)
    got = aer.aerosol_optics_lanes(*x)
    want = ref.Aerosols(raw, F64, "cpu").bands(*x)
    for g, w in zip(got, want):
        close(g, w.permute(2, 1, 0))
    tau = got[0]
    if code in (0, 8):
        assert bool((tau == 0).all())
    else:
        assert bool((tau > 0).all())


def _clouds(seed):
    """Clouds' (tau, tau*ssa, tau*ssa*g) lanes, (NBND, NLAY, NCOL), a
    third of the cells clear."""
    g = torch.Generator().manual_seed(seed)
    u = lambda: torch.rand((NBND, NLAY, NCOL), generator=g, dtype=F64)
    t = u() * 3.0 * (u() > 0.33)
    ts = t * (0.4 + 0.6 * u())
    return t, ts, ts * (0.6 + 0.35 * u())


@pytest.mark.parametrize("band", ["lw", "sw"])
@pytest.mark.parametrize("clouds", [False, True], ids=["clear", "cloudy"])
def test_increments_match_reference(tables, band, clouds):
    raw, aer = tables
    atype = torch.as_tensor(np.random.default_rng(1).integers(
        0, 9, (NCOL, NLAY)), dtype=torch.int32)
    x = (atype,) + cells(3, "between")[1:]
    cloud = _clouds(4) if clouds else None
    a = [v.permute(2, 1, 0) for v in ref.Aerosols(raw, F64, "cpu").bands(*x)]
    if band == "lw":
        got = aer.absorption_lanes(*x, cloud=cloud)
        want = a[0] - a[1]
        if clouds:
            want = (cloud[0] - cloud[1]) + want
        close(got, want)
        return
    got = aer.scattering_lanes(*x, cloud=cloud)
    want = ref._delta_scaled(*a)
    if clouds:
        want = ref._increment(ref._delta_scaled(*cloud), want)
    for g, w in zip(got, want):
        close(g, w)


def _program64(data, state):
    """The fused all-sky step with aerosols in float64 on the CPU (the
    kernels' twins), on the benchmark's tables and state; mu0 drawn
    in [0.1, 1] so that SW runs on every column."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import (AllSkyInputs,
                                                     allsky_step_lw,
                                                     allsky_step_sw)
    from rte_rrtmgp_tpu_torch.models.rrtmgp.cloud_optics import \
        CloudOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import \
        GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist
    from torch_bench.traffic import generator
    host = generator.host
    gas = lambda raw: GasOpticsRRTMGP(KDist.from_raw(
        generator.GASES, dtype=F64, device="cpu", **host(raw)))
    cld = lambda k: CloudOpticsRRTMGP.load(dtype=F64, device="cpu",
                                           **host(data[k]))
    aer = lambda k: AerosolOpticsMERRA.load(dtype=F64, device="cpu",
                                            **data[k])
    x = harness.load("entries", "allsky_stream_aer").inputs(state)
    x = AllSkyInputs(*[v.double() if isinstance(v, torch.Tensor)
                       and v.is_floating_point() else v for v in x])
    x = x._replace(gas_concs=x.gas_concs.to(dtype=F64))
    kw = dict(use_aerosols=True)
    lw = allsky_step_lw(x, gas(data["lw"]), cloud_optics=cld("cloud_lw"),
                        aerosol_optics=aer("aerosol_lw"), **kw)
    sw = allsky_step_sw(x, gas(data["sw"]), cloud_optics=cld("cloud_sw"),
                        aerosol_optics=aer("aerosol_sw"), **kw)
    return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir)


def test_fused_step_with_aerosols_matches_reference():
    from torch_bench.traffic import generator
    spec = copy.deepcopy(harness.cell_spec("ne30pg2_aer.stream.fwd"))
    config = dict(spec["config"], ncol=NCOL, nlay=20)
    data = generator.make(config, spec["cell"]["traffic"], 5, "cpu")
    state = dict(data["pool"][1])
    state["mu0"] = torch.linspace(0.1, 1.0, NCOL)
    types = set(state["aero_type"].unique().tolist())
    assert types == {0, 1, 3}
    got = _program64(data, state)
    want = ref.forward(data, state, F64)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) < 1e-10
    # the aerosols move the fluxes
    clear = dict(state, aero_type=torch.zeros_like(state["aero_type"]))
    assert float((ref.forward(data, clear, F64)[0] - want[0]).abs().max()) \
        > 1e-3


@pytest.mark.parametrize("mode", ["lanes", "lw", "sw"])
def test_lookup_gradient(tables, mode):
    _, aer = tables
    n = 3
    atype = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 0], [3, 2, 6, 4]],
                         dtype=torch.int32)
    size = torch.full((n, 4), 0.5, dtype=F64)
    mass = torch.rand((n, 4), dtype=F64, generator=torch.Generator()
                      .manual_seed(2)).mul(1e-3).requires_grad_()
    rh = torch.tensor([[0.35, 0.52, 0.61, 0.74]] * n, dtype=F64,
                      requires_grad=True)
    c = [v[:, :4, :n].clone().requires_grad_() for v in _clouds(6)]

    def f(mass, rh, c0, c1, c2):
        if mode == "lanes":
            return aer.aerosol_optics_lanes(atype, size, mass, rh)
        if mode == "lw":
            return aer.absorption_lanes(atype, size, mass, rh,
                                        cloud=(c0, c1, c2))
        return aer.scattering_lanes(atype, size, mass, rh,
                                    cloud=(c0, c1, c2))
    assert torch.autograd.gradcheck(f, (mass, rh, *c))


def test_range_check_reads_once(tables):
    _, aer = tables
    x = cells(3, "between")
    with trace.collect() as rec:
        aer.aerosol_optics(*x)
    assert rec.counters["waits"] == 1
    assert [r[0] for r in rec.spans].count("wait.aerosol.ranges") == 1
    bad = x[3].clone()
    bad[2, 3] = 1.5
    with pytest.raises(ValueError, match="humidity"):
        aer.aerosol_optics(x[0], x[1], x[2], bad)
    big = x[1].clone()
    big[0, 0] = 50.0
    with pytest.raises(ValueError, match="size"):
        aer.aerosol_optics(x[0], big, x[2], x[3])
