"""The CUDA kernels against their plain twins on the card (marker ``cuda``).

These tests need a CUDA device and skip without one. They import no JAX,
so they run on a GPU host that has none, without the JAX-side conftest:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small shapes, including a g-point count that is not a multiple of the
32-thread warp (the kernels' idle lanes). The lane solvers get both the
gathers' output as permuted views (the staged path's strides) and
contiguous (g-point, layer, column) copies. Kernel and twin get the same
float32 inputs and differ in summation order and fused multiply-adds
only: cloud optics and the gas-optics gathers within 1e-6 of the largest
value, fluxes within 2e-6 of the largest flux (measured at the main
paths' shapes: below 1e-7 and about 2e-7). The four adjoint kernels
against the twins' autograd on the same inputs and seeded cotangents,
each cotangent within 5e-4 of its largest twin value (the JAX package's
float32 bound, tests/test_fused_autodiff.py:641-642); gradient steps
through the fused step and the public API launch each adjoint once and
give the same bits twice; every kernel wrapper either carries a backward
or refuses an input that requires grad. The LW two-stream kernel, the
by-band output of the solvers and fused steps (uniform, ragged and
reordered bands through gpt2band) and the incident fluxes of the fused
steps and their adjoints (inc_b, incdif_b) against their twins, the
two-stream path's launches, and the secant forms on the card.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_lw_inputs, allsky_staged_lw,
    allsky_staged_sw, allsky_sw_inputs, build_allsky, build_allsky_step)
from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (  # noqa: E402
    cloud_props, cloud_props_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    lw_fused, lw_fused_bwd, lw_fused_bwd_plain, lw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused, sw_fused_bwd, sw_fused_bwd_plain, sw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (  # noqa: E402
    gas_major, gas_major_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (  # noqa: E402
    gas_minor, gas_minor_plain, gas_rayleigh, gas_rayleigh_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import (  # noqa: E402
    lw_noscat, lw_noscat_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (  # noqa: E402
    lw_2stream, lw_2stream_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lanes import (  # noqa: E402
    lw_noscat_lanes, lw_noscat_lanes_pfrac, lw_noscat_lanes_pfrac_plain,
    lw_noscat_lanes_plain, sw_2stream_lanes, sw_2stream_lanes_combined,
    sw_2stream_lanes_combined_plain, sw_2stream_lanes_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_bwd import (  # noqa: E402
    lw_noscat_bwd, lw_noscat_bwd_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import (  # noqa: E402
    sw_2stream, sw_2stream_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw_bwd import (  # noqa: E402
    sw_2stream_bwd, sw_2stream_bwd_plain)
from rte_rrtmgp_tpu_torch.optical_props import (  # noqa: E402
    delta_scale, increment)

pytestmark = pytest.mark.cuda

DIMS = {"g32": (10, 9, 32, 4, 32, 4, 5, 10),
        "g24": (7, 12, 24, 3, 40, 5, 6, 11)}
# bands of 4 g-points: the staged path takes the plain lane solvers
NONBANDED = (9, 7, 24, 6, 24, 6, 5, 10)
LANE_KERNELS = (lw_noscat_lanes, lw_noscat_lanes_pfrac, sw_2stream_lanes,
                sw_2stream_lanes_combined)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, ref, tol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert float((g - r).abs().max()) <= tol * float(r.abs().max())


@pytest.mark.parametrize("dims", sorted(DIMS))
def test_kernels_match_twins(cuda, dims):
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    args = p.cld_lw.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei) \
        + p.cld_lw.tables()
    n0 = cloud_props.launches
    _close(cloud_props(*args), cloud_props_plain(*args), 1e-6)
    assert cloud_props.launches == n0 + 1
    x = allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw)
    n0 = lw_fused.launches
    _close(lw_fused(x), lw_fused_plain(x), 2e-6)
    assert lw_fused.launches == n0 + 1
    x = allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw)
    n0 = sw_fused.launches
    _close(sw_fused(x), sw_fused_plain(x), 2e-6)
    assert sw_fused.launches == n0 + 1
    torch.cuda.synchronize()


def test_sw_kernel_low_sun_and_night(cuda):
    """Per-column mu0 from night (0) through below the min_mu0 clamp
    (sqrt(eps) = 3.5e-4) to overhead: the kernel's clamps and night
    masking agree with the twin, and a night column has no flux."""
    p = build_allsky(*DIMS["g32"], device=cuda)
    x = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
    nlay, ncol = x.mu0.shape
    mu = torch.tensor([0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86, 0.99,
                       1.0], device=cuda)[:ncol]
    x = x._replace(mu0=mu[None, :].expand(nlay, ncol).contiguous())
    got = sw_fused(x)
    _close(got, sw_fused_plain(x), 2e-6)
    assert all(bool((f[:, 0] == 0).all()) for f in got)


def test_step_runs_on_kernels(cuda):
    step, inputs = build_allsky_step(*DIMS["g32"], device=cuda)
    counters = (cloud_props, lw_fused, sw_fused)
    before = [f.launches for f in counters]
    out = step(inputs)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(counters, before))
    for o in out:
        assert o.is_cuda and bool(torch.isfinite(o).all())


def test_wrappers_refuse_float64(cuda):
    p = build_allsky(*DIMS["g32"], device=cuda, dtype=torch.float64)
    inp = p.inputs
    args = p.cld_lw.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei) \
        + p.cld_lw.tables()
    with pytest.raises(ValueError, match="dtype"):
        cloud_props(*args)
    x = allsky_lw_inputs(inp, p.gas_lw, use_clouds=False)
    with pytest.raises(ValueError, match="dtype"):
        lw_fused(x)


def _descriptors(p, gas):
    inp = p.inputs
    cg, dry, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
    return gas.interp(inp.play, inp.tlay, cg), cg, dry, h2o


@pytest.mark.parametrize("dims", sorted(DIMS))
def test_gas_major_matches_twin(cuda, dims):
    p = build_allsky(*DIMS[dims], device=cuda)
    for gas in (p.gas_lw, p.gas_sw):
        co = _descriptors(p, gas)[0]
        args = (co, gas.kdist.kmajor, gas.kdist.planck_frac,
                gas.gpoint_flavor)
        n0 = gas_major.launches
        got = tuple(x for x in gas_major(*args) if x is not None)
        assert gas_major.launches == n0 + 1
        _close(got, tuple(x for x in gas_major_plain(*args)
                          if x is not None), 1e-6)


@pytest.mark.parametrize("dims", sorted(DIMS))
def test_gas_minor_matches_twin(cuda, dims):
    p = build_allsky(*DIMS[dims], device=cuda)
    gas, inp = p.gas_lw, p.inputs
    co, cg, _, h2o = _descriptors(p, gas)
    kd = gas.kdist
    tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
    nlo = len(kd.minor_lower)
    for lower, mset, ktab, meta in (
            (True, kd.minor_lower, kd.kminor_lower, gas.minor_meta[:nlo]),
            (False, kd.minor_upper, kd.kminor_upper, gas.minor_meta[nlo:])):
        minors = tuple(m[1:] for m in gas.minors if bool(m[0]) == lower)
        sc = minor_scaling(co, mset, lower=lower, play=inp.play,
                           tlay=inp.tlay, col_gas=cg, idx_h2o=h2o)
        n0 = gas_minor.launches
        got = gas_minor(tau.clone(), co, ktab, minors, meta, sc)
        assert gas_minor.launches == n0 + 1
        _close(got, gas_minor_plain(tau.clone(), co, ktab, minors, meta, sc),
               1e-6)


@pytest.mark.parametrize("scattering", [True, False])
def test_gas_rayleigh_matches_twin(cuda, scattering):
    p = build_allsky(*DIMS["g24"], device=cuda)
    gas = p.gas_sw
    co, cg, dry, h2o = _descriptors(p, gas)
    kd = gas.kdist
    tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
    args = (co, kd.krayl, gas.gpoint_flavor, (cg[h2o] + dry).contiguous(),
            scattering)
    n0 = gas_rayleigh.launches
    got = tuple(x for x in gas_rayleigh(tau.clone(), *args) if x is not None)
    assert gas_rayleigh.launches == n0 + 1
    ref = tuple(x for x in gas_rayleigh_plain(tau.clone(), *args)
                if x is not None)
    assert len(got) == len(ref) == (2 if scattering else 1)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("variant", ["plain", "rescale-jac-ds"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_lw_noscat_matches_twin(cuda, dims, variant):
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                        inp.tsfc, inp.gas_concs,
                                        tlev=inp.tlev)
    gen = torch.Generator(device=cuda).manual_seed(1)
    ncol, nlay, ngpt = props.tau.shape
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    args = (props.tau, src.lay_source, src.lev_source,
            0.8 + 0.2 * rand(ncol, ngpt), src.sfc_source, rand(ncol, ngpt))
    kw = dict(ds=1.66, weight=1.0)
    if variant != "plain":
        kw = dict(ds=p.gas_lw.compute_optimal_angles(props), weight=1.0,
                  sfc_src_jac=src.sfc_source_jac,
                  ssa=0.6 * rand(ncol, nlay, ngpt),
                  g=0.9 * rand(ncol, nlay, ngpt))
    n0 = lw_noscat.launches
    got = tuple(x for x in lw_noscat(*args, **kw) if x is not None)
    assert lw_noscat.launches == n0 + 1
    ref = tuple(x for x in lw_noscat_plain(*args, **kw) if x is not None)
    assert len(got) == len(ref) == (2 if variant == "plain" else 3)
    _close(got, ref, 2e-6)


@pytest.mark.parametrize("dims", sorted(DIMS))
def test_sw_2stream_matches_twin(cuda, dims):
    """Night, low-sun and overhead columns, mu0 that varies by layer and a
    diffuse incident flux."""
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    props, toa = p.gas_sw.gas_optics_sw(inp.play, inp.plev, inp.tlay,
                                        inp.gas_concs)
    ncol, nlay, ngpt = props.tau.shape
    mu = torch.tensor([-0.3, 0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86,
                       1.0], device=cuda)[:ncol]
    mu0 = (mu[:, None] * torch.linspace(1.0, 0.95, nlay, device=cuda)
           ).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(2)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    inc = toa.contiguous()
    args = (props.tau, 0.99 * rand(ncol, nlay, ngpt),
            0.85 * rand(ncol, nlay, ngpt), mu0, 0.3 * rand(ncol, ngpt),
            0.3 * rand(ncol, ngpt), inc, 0.05 * inc)
    n0 = sw_2stream.launches
    got = sw_2stream(*args)
    assert sw_2stream.launches == n0 + 1
    _close(got, sw_2stream_plain(*args), 2e-6)


def test_public_path_runs_on_kernels(cuda):
    p = build_allsky(*DIMS["g32"], device=cuda)
    counters = (cloud_props, gas_major, gas_minor, gas_rayleigh, lw_noscat,
                sw_2stream)
    before = [f.launches for f in counters]
    fused_before = (lw_fused.launches, sw_fused.launches)
    lw = allsky_api_lw(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
    sw = allsky_api_sw(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(counters, before))
    assert (lw_fused.launches, sw_fused.launches) == fused_before
    for o in (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
              sw.flux_dn_dir):
        assert o.is_cuda and bool(torch.isfinite(o).all())


def _lane_cases(p, cuda):
    """The staged path's lane inputs (views) and their contiguous copies."""
    inp = p.inputs
    tau, pfrac, (pbs, pbl, pbv) = p.gas_lw.gas_optics_lw_lanes(
        inp.play, inp.plev, inp.tlay, inp.tsfc, inp.gas_concs,
        tlev=inp.tlev, banded_planck=True)
    return [(tau, pfrac, pbl, pbv, pbs),
            tuple(x.contiguous() for x in (tau, pfrac, pbl, pbv, pbs))]


@pytest.mark.parametrize("variant", ["plain", "rescale-jac"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_lw_noscat_lanes_matches_twin(cuda, dims, variant):
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    tau, (sfc, lay, lev, jac) = p.gas_lw.gas_optics_lw_lanes(
        inp.play, inp.plev, inp.tlay, inp.tsfc, inp.gas_concs, tlev=inp.tlev)
    ngpt, nlay, ncol = tau.shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    kw = dict(ds=1.66, weight=0.7)
    if variant != "plain":
        kw.update(ssa=0.6 * rand(ngpt, nlay, ncol),
                  g=0.9 * rand(ngpt, nlay, ncol), sfc_src_jac=jac,
                  do_rescaling=True, do_jacobians=True)
    for fields in ((tau, lay, lev), tuple(x.contiguous()
                                          for x in (tau, lay, lev))):
        args = fields + (0.8 + 0.2 * rand(ngpt, ncol), sfc,
                         rand(ngpt, ncol))
        n0 = lw_noscat_lanes.launches
        got = tuple(x for x in lw_noscat_lanes(*args, **kw) if x is not None)
        assert lw_noscat_lanes.launches == n0 + 1
        ref = tuple(x for x in lw_noscat_lanes_plain(*args, **kw)
                    if x is not None)
        assert len(got) == len(ref) == (2 if variant == "plain" else 3)
        _close(got, ref, 2e-6)


@pytest.mark.parametrize("cloud", [False, True], ids=["clear", "cloud"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_lw_noscat_lanes_pfrac_matches_twin(cuda, dims, cloud):
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    cld = None
    if cloud:
        t, ts, _ = p.cld_lw.cloud_optics_lanes(inp.lwp, inp.iwp, inp.rel,
                                               inp.dei)
        cld = t - ts
    ngpt, ncol = p.gas_lw.ngpt, inp.play.shape[0]
    emis = inp.sfc_emis[:, 0][None, :].expand(ngpt, ncol)
    inc = 0.5 * torch.ones((ngpt, ncol), device=cuda)
    for tau, pfrac, pbl, pbv, pbs in _lane_cases(p, cuda):
        args = (tau, pfrac, pbl, pbv, pbs, emis, inc)
        kw = dict(ds=1.66, weight=1.0, gpt2band=p.gas_lw.gpt2band,
                  cloud_tau_abs=cld)
        n0 = lw_noscat_lanes_pfrac.launches
        got = lw_noscat_lanes_pfrac(*args, **kw)
        assert lw_noscat_lanes_pfrac.launches == n0 + 1
        _close(got, lw_noscat_lanes_pfrac_plain(*args, **kw), 2e-6)


def _sw_bounds(p, cuda, ngpt, nlay, ncol):
    """mu0 (nlay, ncol) with night, low-sun and overhead columns varying by
    layer; albedos, TOA flux and a diffuse TOA flux (ngpt, ncol)."""
    mu = torch.tensor([-0.3, 0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86,
                       1.0], device=cuda)[torch.arange(ncol) % 10]
    mu0 = mu[None, :] * torch.linspace(1.0, 0.95, nlay, device=cuda)[:, None]
    gen = torch.Generator(device=cuda).manual_seed(4)
    alb = 0.3 * torch.rand((ngpt, ncol), generator=gen, device=cuda)
    toa = p.gas_sw.kdist.solar_source[:, None].expand(ngpt, ncol)
    return mu0, alb, alb.flip(0), toa, 0.05 * toa


@pytest.mark.parametrize("diffuse", [False, True], ids=["dir", "dir-dif"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_sw_2stream_lanes_matches_twin(cuda, dims, diffuse):
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    tau, ssa, _ = p.gas_sw.gas_optics_sw_lanes(inp.play, inp.plev, inp.tlay,
                                               inp.gas_concs)
    ngpt, nlay, ncol = tau.shape
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = 0.85 * torch.rand((ngpt, nlay, ncol), generator=gen, device=cuda)
    mu0, adir, adif, toa, dif = _sw_bounds(p, cuda, ngpt, nlay, ncol)
    for fields in ((tau, ssa, g), tuple(x.contiguous()
                                        for x in (tau, ssa, g))):
        args = fields + (mu0, adir, adif, toa, dif if diffuse else None)
        n0 = sw_2stream_lanes.launches
        got = sw_2stream_lanes(*args)
        assert sw_2stream_lanes.launches == n0 + 1
        _close(got, sw_2stream_lanes_plain(*args), 2e-6)


@pytest.mark.parametrize("cloud", [False, True], ids=["clear", "cloud"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_sw_2stream_lanes_combined_matches_twin(cuda, dims, cloud):
    p = build_allsky(*DIMS[dims], device=cuda, use_aerosols=True)
    inp = p.inputs
    tau, ray, _ = p.gas_sw.gas_optics_sw_lanes(
        inp.play, inp.plev, inp.tlay, inp.gas_concs, split_rayleigh=True)
    ngpt, nlay, ncol = tau.shape
    from rte_rrtmgp_tpu_torch.drivers.allsky import _scattering_lanes
    cld = (_scattering_lanes(inp, p.cld_sw, True, p.aer_sw, True)
           if cloud else None)
    mu0, adir, adif, toa, dif = _sw_bounds(p, cuda, ngpt, nlay, ncol)
    for fields in ((tau, ray), (tau.contiguous(), ray.contiguous())):
        args = fields + (cld, mu0, adir, adif, toa, dif)
        kw = dict(gpt2band=p.gas_sw.gpt2band)
        n0 = sw_2stream_lanes_combined.launches
        got = sw_2stream_lanes_combined(*args, **kw)
        assert sw_2stream_lanes_combined.launches == n0 + 1
        _close(got, sw_2stream_lanes_combined_plain(*args, **kw), 2e-6)


@pytest.mark.parametrize("dims", ["banded", "nonbanded"])
def test_staged_path_runs_on_kernels(cuda, dims):
    """Banded k-distributions launch the in-kernel-sources and combined
    solvers, the others the plain lane solvers; no fused kernel, and the
    fluxes agree with the fused step's (rtol 3e-5 / atol 5e-4 W/m2)."""
    d = DIMS["g32"] if dims == "banded" else NONBANDED
    p = build_allsky(*d, device=cuda, use_aerosols=True)
    want = ((lw_noscat_lanes_pfrac, sw_2stream_lanes_combined)
            if dims == "banded" else (lw_noscat_lanes, sw_2stream_lanes))
    counters = LANE_KERNELS + (cloud_props, gas_major, gas_minor,
                               gas_rayleigh, lw_fused, sw_fused)
    before = {f: f.launches for f in counters}
    kw = dict(use_aerosols=True)
    lw = allsky_staged_lw(p.inputs, p.gas_lw, cloud_optics=p.cld_lw,
                          aerosol_optics=p.aer_lw, **kw)
    sw = allsky_staged_sw(p.inputs, p.gas_sw, cloud_optics=p.cld_sw,
                          aerosol_optics=p.aer_sw, **kw)
    torch.cuda.synchronize()
    moved = {f for f in counters if f.launches > before[f]}
    assert moved == set(want) | {cloud_props, gas_major, gas_minor,
                                 gas_rayleigh}
    step, _ = build_allsky_step(*d, device=cuda, use_aerosols=True)
    fused = step(p.inputs)
    for got, ref in zip((lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                         sw.flux_dn_dir), fused):
        assert got.is_cuda and bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= 5e-4 + 3e-5 * ref.abs()).all())


def test_aerosols_fused_step_runs_on_kernels(cuda):
    step, inputs = build_allsky_step(*DIMS["g32"], device=cuda,
                                     use_aerosols=True)
    counters = (cloud_props, lw_fused, sw_fused)
    before = [f.launches for f in counters]
    out = step(inputs)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(counters, before))
    for o in out:
        assert o.is_cuda and bool(torch.isfinite(o).all())


def test_lane_wrappers_refuse_float64(cuda):
    """The staged path's lane inputs in float64 on the card: each lane
    wrapper raises and launches nothing."""
    p = build_allsky(*DIMS["g32"], device=cuda)
    inp = p.inputs
    f64 = lambda xs: tuple(x.double() for x in xs)
    tau, pfrac, pbl, pbv, pbs = f64(_lane_cases(p, cuda)[0])
    ngpt, nlay, ncol = tau.shape
    bc = torch.ones((ngpt, ncol), dtype=torch.float64, device=cuda)
    stau, sray, toa = f64(p.gas_sw.gas_optics_sw_lanes(
        inp.play, inp.plev, inp.tlay, inp.gas_concs, split_rayleigh=True))
    mu0 = inp.mu0[None, :].expand(nlay, ncol).double()
    counts = [f.launches for f in LANE_KERNELS]
    with pytest.raises(ValueError, match="dtype"):
        lw_noscat_lanes_pfrac(tau, pfrac, pbl, pbv, pbs, bc, bc, ds=1.66,
                              weight=1.0, gpt2band=p.gas_lw.gpt2band)
    with pytest.raises(ValueError, match="dtype"):
        lw_noscat_lanes(tau, tau, pbv[:1].expand(ngpt, nlay + 1, ncol), bc,
                        bc, bc, ds=1.66, weight=1.0)
    with pytest.raises(ValueError, match="dtype"):
        sw_2stream_lanes(stau, sray, sray, mu0, bc, bc, toa)
    with pytest.raises(ValueError, match="dtype"):
        sw_2stream_lanes_combined(stau, sray, None, mu0, bc, bc, toa,
                                  gpt2band=p.gas_sw.gpt2band)
    assert [f.launches for f in LANE_KERNELS] == counts


# ---------------------------------------------------------------------------
# the adjoint kernels and the gradients through the port
# ---------------------------------------------------------------------------

ADJOINTS = {"fused_lw_bwd": (lw_fused_bwd, lw_fused_bwd_plain),
            "fused_sw_bwd": (sw_fused_bwd, sw_fused_bwd_plain),
            "lw_noscat_bwd": (lw_noscat_bwd, lw_noscat_bwd_plain),
            "sw_2stream_bwd": (sw_2stream_bwd, sw_2stream_bwd_plain)}
TOL_ADJ = 5e-4
# where float32 cannot resolve a cotangent at all, the kernel within this
# factor of the float32 twin's distance from the float64 twin (row 8's
# rule in chip_smoke.py)
TOL_COND = 2.0
# the adjoints' cases: DIMS, where no band spans a second warp, and the
# paths' own widths at a few columns and the full 72 layers: the flagship
# (LW 256 g-points / 16 bands, SW 224 / 14), the non-banded 12-wide bands
# (192 / 168 g-points: bands and minor windows that cross warps), one
# column, an odd count, one layer, and the flagship with clouds off. The
# SW solver gets its low suns (mu0 down to 1e-4) in the DIMS cases and in
# test_sw_solver_adjoint_low_suns, the path's mu0 in the others
FLAGSHIP = (3, 72, 256, 16, 224, 14, 14, 59)
NONBANDED_72 = (3, 72, 192, 16, 168, 14, 14, 59)
ADJ_CASES = {**{k: (v, True) for k, v in DIMS.items()},
             "flagship": (FLAGSHIP, True),
             "nonbanded": (NONBANDED_72, True),
             "ncol1": ((1,) + FLAGSHIP[1:], True),
             "ncol5": ((5,) + FLAGSHIP[1:], True),
             "nlay1": ((4, 1) + FLAGSHIP[2:], True),
             "clear": (FLAGSHIP, False)}
# the cotangents float32 cannot resolve over 72 layers at the paths'
# widths (nearly transparent upper layers; nearly conservative Rayleigh
# scattering): the fused SW adjoint's col_mix, minor_scale and cloud, the
# SW solver's ssa. Only these, and only outside DIMS, may be held to the
# float64 twin where the float32 twin misses TOL_ADJ.
BEYOND_F32 = {"fused_sw_bwd": (3, 4, 6), "sw_2stream_bwd": (1,)}


def _adjoint_args(p, cuda, name, clouds=True, low_suns=True):
    """The arguments and keywords of one adjoint on the inputs its path
    gives it (clouds on unless ``clouds`` is False) and seeded cotangents
    of the broadband fluxes; with ``low_suns`` the SW solver gets a night
    column and suns down to mu0 = 1e-4 that vary by layer, else the
    path's mu0 (as chip_smoke.py gives it)."""
    inp = p.inputs
    ncol, nlay = inp.play.shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    cot = lambda *s: 0.5 + torch.rand(s, generator=gen, device=cuda)
    if name == "fused_lw_bwd":
        x = allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw,
                             use_clouds=clouds)
        return (x, cot(nlay + 1, ncol), cot(nlay + 1, ncol)), {}
    if name == "fused_sw_bwd":
        x = allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw,
                             use_clouds=clouds)
        return (x,) + tuple(cot(nlay + 1, ncol) for _ in range(3)), {}
    if name == "lw_noscat_bwd":
        props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                            inp.tsfc, inp.gas_concs,
                                            tlev=inp.tlev, top_at_1=True)
        if clouds:
            props = increment(props, p.cld_lw.cloud_optics(
                inp.lwp, inp.iwp, inp.rel, inp.dei, scattering=False))
        emis = inp.sfc_emis.expand(ncol, props.tau.shape[2]).contiguous()
        return ((props.tau.contiguous(), src.lay_source, src.lev_source,
                 emis, src.sfc_source, 0.1 * emis, cot(ncol, nlay + 1),
                 cot(ncol, nlay + 1)), dict(ds=1.66, weight=0.5))
    props, toa = p.gas_sw.gas_optics_sw(inp.play, inp.plev, inp.tlay,
                                        inp.gas_concs, top_at_1=True)
    if clouds:
        props = increment(props, delta_scale(p.cld_sw.cloud_optics(
            inp.lwp, inp.iwp, inp.rel, inp.dei)))
    ngpt = props.tau.shape[2]
    mu = torch.tensor([0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86, 0.99,
                       1.0], device=cuda)[torch.arange(ncol) % 10]
    mu0 = (mu[:, None] * torch.linspace(1.0, 0.95, nlay, device=cuda)
           if low_suns else inp.mu0[:, None].expand(ncol, nlay)).contiguous()
    alb = inp.sfc_alb.expand(ncol, ngpt).contiguous()
    inc = toa.contiguous()
    return ((props.tau.contiguous(), props.ssa.contiguous(),
             props.g.contiguous(), mu0, alb, 0.5 * alb, inc, 0.05 * inc)
            + tuple(cot(ncol, nlay + 1) for _ in range(3))), {}


def _to_f64(tree):
    """``tree`` (tensors in nested tuples and NamedTuples) with every float
    tensor in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_f64(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_f64(v) for v in tree)
    return tree


def _twin_f64(plain, args, kw, monkeypatch):
    """The twin in float64 with float32's eps and tiny in its clamps and
    guards (the kernels use those in every dtype): the float32 algorithm
    in float64 arithmetic."""
    finfo = torch.finfo
    monkeypatch.setattr(torch, "finfo", lambda dtype=None: finfo(
        torch.float32))
    try:
        return plain(*_to_f64(args), **kw)
    finally:
        monkeypatch.setattr(torch, "finfo", finfo)


def _against_f64(got, ref, ref64, i):
    """Cotangent i's distances from the float64 twin's, kernel and float32
    twin, as fractions of its largest float64 value."""
    scale = float(ref64[i].abs().max())
    return (float((got[i].double() - ref64[i]).abs().max()) / scale,
            float((ref[i].double() - ref64[i]).abs().max()) / scale)


@pytest.mark.parametrize("name", sorted(ADJOINTS))
@pytest.mark.parametrize("dims", sorted(ADJ_CASES))
def test_adjoint_kernels_match_twins(cuda, dims, name, monkeypatch):
    """Each cotangent within TOL_ADJ of its largest twin value; outside
    DIMS, a cotangent of BEYOND_F32 whose float32 twin is itself further
    than that from the float64 twin is held within TOL_ADJ of the float64
    twin's instead (chip_smoke.py's rule); one launch per call, the same
    bits on a second call."""
    kernel, plain = ADJOINTS[name]
    case, clouds = ADJ_CASES[dims]
    p = build_allsky(*case, device=cuda)
    args, kw = _adjoint_args(p, cuda, name, clouds, low_suns=dims in DIMS)
    n0 = kernel.launches
    got = kernel(*args, **kw)
    assert kernel.launches == n0 + 1
    ref = plain(*args, **kw)
    assert len(got) == len(ref)
    ref64 = None
    for i, (g, r) in enumerate(zip(got, ref)):
        assert (g is None) == (r is None)
        if r is None:
            continue
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        within = (float((g - r).abs().max())
                  <= TOL_ADJ * float(r.abs().max()))
        if dims in DIMS or i not in BEYOND_F32.get(name, ()):
            assert within, f"cotangent {i}"
            continue
        if within:
            continue
        if ref64 is None:
            ref64 = _twin_f64(plain, args, kw, monkeypatch)
        k64, t64 = _against_f64(got, ref, ref64, i)
        assert t64 > TOL_ADJ and k64 <= TOL_ADJ, f"cotangent {i}"
    again = kernel(*args, **kw)
    assert kernel.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.parametrize("case", [FLAGSHIP, NONBANDED_72],
                         ids=["flagship", "nonbanded"])
def test_sw_solver_adjoint_low_suns(cuda, case, monkeypatch):
    """The SW solver's adjoint over 72 layers at the paths' widths, ten
    columns with a night column and suns down to mu0 = 1e-4 that vary by
    layer: float32 cannot resolve the ssa, g and mu0 cotangents there (the
    float32 twin is orders beyond TOL_ADJ of the float64 twin), so each of
    those is held, where the float32 twin misses TOL_ADJ, within TOL_COND
    times the float32 twin's distance from the float64 twin; every other
    cotangent within TOL_ADJ of the twin's; the same bits twice."""
    p = build_allsky(10, *case[1:], device=cuda)
    args, kw = _adjoint_args(p, cuda, "sw_2stream_bwd", low_suns=True)
    got = sw_2stream_bwd(*args, **kw)
    ref = sw_2stream_bwd_plain(*args, **kw)
    ref64 = _twin_f64(sw_2stream_bwd_plain, args, kw, monkeypatch)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        if float((g - r).abs().max()) <= TOL_ADJ * float(r.abs().max()):
            continue
        assert i in (1, 2, 3), f"cotangent {i}"
        k64, t64 = _against_f64(got, ref, ref64, i)
        print(f"sw_2stream_bwd low suns, ngpt {case[4]}: cotangent {i} "
              f"against the float64 twin: kernel {k64:.3e}, float32 twin "
              f"{t64:.3e} of its largest value")
        assert t64 > TOL_ADJ and k64 <= TOL_COND * t64, f"cotangent {i}"
    again = sw_2stream_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _train_grads(step, inputs):
    """d/d(tlay, tsfc, lwp, rel) of the weighted flux loss of one step."""
    ncol, nlay = inputs.play.shape
    leaves = {k: getattr(inputs, k).detach().clone().requires_grad_()
              for k in ("tlay", "tsfc", "lwp", "rel")}
    out = step(inputs._replace(**leaves))
    w = torch.linspace(0.5, 1.5, nlay + 1, device=inputs.play.device)
    loss = sum((w * f).sum() * c for f, c in zip(out, (1, 0.5, 1, 0.5)))
    loss = loss + 0.25 * out[4].sum()
    return torch.autograd.grad(loss, tuple(leaves.values()))


def _api_step(p):
    def step(inputs):
        lw = allsky_api_lw(inputs, p.gas_lw, cloud_optics=p.cld_lw)
        sw = allsky_api_sw(inputs, p.gas_sw, cloud_optics=p.cld_sw)
        return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                sw.flux_dn_dir)
    return step


@pytest.mark.parametrize("path", ["fused", "fused-aerosols", "api"])
def test_gradient_step_launches_adjoints(cuda, path):
    """A gradient step launches each adjoint of its path once and no
    other; finite gradients, not all zero, the same bits twice."""
    if path == "api":
        p = build_allsky(*DIMS["g32"], device=cuda)
        step, inputs = _api_step(p), p.inputs
        want = {lw_noscat_bwd, sw_2stream_bwd}
    else:
        step, inputs = build_allsky_step(
            *DIMS["g32"], device=cuda, use_aerosols=path != "fused")
        want = {lw_fused_bwd, sw_fused_bwd}
    counters = tuple(k for k, _ in ADJOINTS.values())
    before = {f: f.launches for f in counters}
    grads = _train_grads(step, inputs)
    torch.cuda.synchronize()
    assert {f: f.launches - before[f] for f in counters} == {
        f: int(f in want) for f in counters}
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    again = _train_grads(step, inputs)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_staged_path_refuses_grad(cuda):
    """The staged lane-layout branch has no gradient on the card: its
    solvers raise on inputs that require grad and launch nothing."""
    p = build_allsky(*DIMS["g32"], device=cuda)
    inp = p.inputs._replace(
        tlay=p.inputs.tlay.detach().clone().requires_grad_())
    counts = [f.launches for f in LANE_KERNELS]
    with pytest.raises(ValueError, match="staged"):
        allsky_staged_lw(inp, p.gas_lw, cloud_optics=p.cld_lw)
    with pytest.raises(ValueError, match="staged"):
        allsky_staged_sw(inp, p.gas_sw, cloud_optics=p.cld_sw)
    assert [f.launches for f in LANE_KERNELS] == counts


def test_kernel_wrappers_carry_a_backward_or_raise(cuda):
    """Every kernel wrapper, given an input that requires grad: the
    differentiable ones return outputs with a grad_fn, the raw ones
    raise. No output comes back without a gradient."""
    p = build_allsky(*DIMS["g24"], device=cuda)
    inp = p.inputs
    req = lambda t: t.detach().clone().requires_grad_()
    for x in (allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw),
              allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw)):
        fused = lw_fused if hasattr(x, "tlev") else sw_fused
        out = fused(x._replace(co=x.co._replace(ftemp=req(x.co.ftemp))))
        assert all(o.grad_fn is not None for o in out)
    raw = []
    idx, fint, wp = p.cld_lw.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei)
    raw.append(lambda: cloud_props(idx, fint, req(wp), *p.cld_lw.tables()))
    co, cg, dry, h2o = _descriptors(p, p.gas_lw)
    kd = p.gas_lw.kdist
    co_g = co._replace(ftemp=req(co.ftemp))
    raw.append(lambda: gas_major(co_g, kd.kmajor, kd.planck_frac,
                                 p.gas_lw.gpoint_flavor))
    tau = gas_major_plain(co, kd.kmajor, None, p.gas_lw.gpoint_flavor)[0]
    nlo = len(kd.minor_lower)
    minors = tuple(m[1:] for m in p.gas_lw.minors if m[0])
    sc = minor_scaling(co, kd.minor_lower, lower=True, play=inp.play,
                       tlay=inp.tlay, col_gas=cg, idx_h2o=h2o)
    raw.append(lambda: gas_minor(req(tau), co, kd.kminor_lower, minors,
                                 p.gas_lw.minor_meta[:nlo], sc))
    cs, cgs, drys, h2os = _descriptors(p, p.gas_sw)
    kds = p.gas_sw.kdist
    taus = gas_major_plain(cs, kds.kmajor, None, p.gas_sw.gpoint_flavor)[0]
    raw.append(lambda: gas_rayleigh(req(taus), cs, kds.krayl,
                                    p.gas_sw.gpoint_flavor,
                                    (cgs[h2os] + drys).contiguous()))
    for name in ADJOINTS:
        kernel = ADJOINTS[name][0]
        args, kw = _adjoint_args(p, cuda, name)
        raw.append(lambda k=kernel, a=args, kw=kw: k(
            *a[:-1], req(a[-1]), **kw))
        if name == "lw_noscat_bwd":
            raw.append(lambda a=args: lw_noscat(req(a[0]), *a[1:6],
                                                ds=1.66, weight=0.5))
        if name == "sw_2stream_bwd":
            raw.append(lambda a=args: sw_2stream(req(a[0]), *a[1:8]))
    for call in raw:
        with pytest.raises(ValueError, match="no backward"):
            call()


# ---------------------------------------------------------------------------
# the LW two-stream kernel, by-band output and incident fluxes
# ---------------------------------------------------------------------------

def _bands(ngpt, nband, kind, cuda):
    """gpt2band (int32) and the band count: the k-distribution's uniform
    contiguous bands, or three ragged bands whose g-points interleave."""
    if kind == "uniform":
        return torch.arange(ngpt, device=cuda, dtype=torch.int32) // (
            ngpt // nband), nband
    return torch.tensor([(g * g + g // 5) % 3 for g in range(ngpt)],
                        dtype=torch.int32, device=cuda), 3


def _lw2_args(p, cuda, seed=8):
    """The two-stream path's inputs: scattering gas optics with the
    2-stream clouds, and seeded emissivity and incident flux."""
    inp = p.inputs
    props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                        inp.tsfc, inp.gas_concs,
                                        tlev=inp.tlev, scattering=True,
                                        top_at_1=True)
    props = increment(props, p.cld_lw.cloud_optics(
        inp.lwp, inp.iwp, inp.rel, inp.dei, scattering=True))
    ncol, _, ngpt = props.tau.shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    c = lambda x: x.contiguous()
    return (c(props.tau), c(props.ssa), c(props.g), src.lay_source,
            src.lev_source, 0.8 + 0.2 * rand(ncol, ngpt), src.sfc_source,
            2.0 * rand(ncol, ngpt))


@pytest.mark.parametrize("output", ["broadband", "uniform", "ragged"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_lw_2stream_matches_twin(cuda, dims, output):
    p = build_allsky(*DIMS[dims], device=cuda)
    args = _lw2_args(p, cuda)
    kw = {}
    if output != "broadband":
        gpt2band, nband = _bands(args[0].shape[2], DIMS[dims][3], output,
                                 cuda)
        args, kw = args + (gpt2band,), dict(nband=nband)
    n0 = lw_2stream.launches
    got = lw_2stream(*args, **kw)
    assert lw_2stream.launches == n0 + 1
    _close(got, lw_2stream_plain(*args, **kw), 2e-6)
    if output != "broadband":
        bb = lw_2stream(*args[:-1])
        _close(tuple(x.sum(-1) for x in got), bb, 2e-6)


@pytest.mark.parametrize("bands", ["uniform", "ragged"])
@pytest.mark.parametrize("dims", sorted(DIMS))
def test_solvers_byband_match_twins(cuda, dims, bands):
    """lw_noscat (plain, and rescaled with a secant field) and sw_2stream
    with per-band sums, against their twins."""
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                        inp.tsfc, inp.gas_concs,
                                        tlev=inp.tlev)
    ncol, nlay, ngpt = props.tau.shape
    gen = torch.Generator(device=cuda).manual_seed(9)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    gpt2band, nband = _bands(ngpt, DIMS[dims][3], bands, cuda)
    args = (props.tau, src.lay_source, src.lev_source,
            0.8 + 0.2 * rand(ncol, ngpt), src.sfc_source, rand(ncol, ngpt))
    for kw in (dict(ds=1.66, weight=1.0),
               dict(ds=p.gas_lw.compute_optimal_angles(props), weight=1.0,
                    sfc_src_jac=src.sfc_source_jac,
                    ssa=0.6 * rand(ncol, nlay, ngpt),
                    g=0.9 * rand(ncol, nlay, ngpt))):
        kw.update(gpt2band=gpt2band, nband=nband)
        n0 = lw_noscat.launches
        got = tuple(x for x in lw_noscat(*args, **kw) if x is not None)
        assert lw_noscat.launches == n0 + 1
        assert got[0].shape == (ncol, nlay + 1, nband)
        _close(got, tuple(x for x in lw_noscat_plain(*args, **kw)
                          if x is not None), 2e-6)
    sprops, toa = p.gas_sw.gas_optics_sw(inp.play, inp.plev, inp.tlay,
                                         inp.gas_concs)
    ngs = sprops.tau.shape[2]
    gpt2band, nband = _bands(ngs, DIMS[dims][5], bands, cuda)
    mu = torch.tensor([-0.3, 0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86,
                       1.0], device=cuda)[torch.arange(ncol) % 10]
    mu0 = (mu[:, None] * torch.linspace(1.0, 0.95, nlay, device=cuda)
           ).contiguous()
    inc = toa.contiguous()
    sargs = (sprops.tau, 0.99 * rand(ncol, nlay, ngs),
             0.85 * rand(ncol, nlay, ngs), mu0, 0.3 * rand(ncol, ngs),
             0.3 * rand(ncol, ngs), inc, 0.05 * inc, gpt2band)
    n0 = sw_2stream.launches
    got = sw_2stream(*sargs, nband=nband)
    assert sw_2stream.launches == n0 + 1
    _close(got, sw_2stream_plain(*sargs, nband=nband), 2e-6)


@pytest.mark.parametrize("dims", sorted(DIMS))
def test_fused_inc_and_byband_match_twins(cuda, dims):
    """The fused LW step with an incident flux and the fused SW step with
    a diffuse one, broadband and by band, against their twins; the band
    sums equal the broadband fluxes."""
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    gen = torch.Generator(device=cuda).manual_seed(10)
    for fused, plain, make in ((lw_fused, lw_fused_plain, allsky_lw_inputs),
                               (sw_fused, sw_fused_plain, allsky_sw_inputs)):
        gas = p.gas_lw if fused is lw_fused else p.gas_sw
        cld = p.cld_lw if fused is lw_fused else p.cld_sw
        x = make(inp, gas, cloud_optics=cld)
        inc = 3.0 * torch.rand(x.sfc_emis.shape if fused is lw_fused
                               else x.inc.shape, generator=gen, device=cuda)
        x = (x._replace(inc=inc) if fused is lw_fused
             else x._replace(incdif=0.05 * inc * x.inc))
        bb = None
        for byband in (False, True):
            xb = x._replace(byband=byband)
            n0 = fused.launches
            got = fused(xb)
            assert fused.launches == n0 + 1
            _close(got, plain(xb), 2e-6)
            if byband:
                _close(tuple(g.sum(0) for g in got), bb, 2e-6)
            bb = got


def test_fused_adjoints_give_inc_cotangents(cuda):
    """The fused adjoint kernels with a non-zero incident flux (LW) and a
    diffuse incident flux (SW): every cotangent, inc_b and incdif_b
    included, within TOL_ADJ of its twin's autograd."""
    p = build_allsky(*DIMS["g24"], device=cuda)
    inp = p.inputs
    ncol, nlay = inp.play.shape
    gen = torch.Generator(device=cuda).manual_seed(11)
    cot = lambda *s: 0.5 + torch.rand(s, generator=gen, device=cuda)
    x = allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw)
    x = x._replace(inc=cot(*x.sfc_emis.shape))
    lw = (x, cot(nlay + 1, ncol), cot(nlay + 1, ncol))
    x = allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw)
    x = x._replace(incdif=0.05 * x.inc * cot(*x.inc.shape))
    sw = (x,) + tuple(cot(nlay + 1, ncol) for _ in range(3))
    for kernel, plain, args, idx in ((lw_fused_bwd, lw_fused_bwd_plain, lw,
                                      9), (sw_fused_bwd, sw_fused_bwd_plain,
                                           sw, 11)):
        n0 = kernel.launches
        got = kernel(*args)
        assert kernel.launches == n0 + 1
        ref = plain(*args)
        assert len(got) == len(ref) and got[idx] is not None
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is None:
                continue
            assert g.shape == r.shape and bool(torch.isfinite(g).all())
            assert float((g - r).abs().max()) <= TOL_ADJ * float(
                r.abs().max())
        assert bool((got[idx] != 0).any())


def test_two_stream_path_runs_on_kernels(cuda):
    """rte_lw(use_2stream=True) on CUDA tensors: one two-stream launch per
    call, broadband or by band, no no-scattering launch, the CPU twins'
    fluxes."""
    import dataclasses
    from rte_rrtmgp_tpu_torch.rte import rte_lw
    p = build_allsky(*DIMS["g32"], device=cuda)
    inp = p.inputs
    props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                        inp.tsfc, inp.gas_concs,
                                        tlev=inp.tlev, scattering=True)
    props = increment(props, p.cld_lw.cloud_optics(
        inp.lwp, inp.iwp, inp.rel, inp.dei, scattering=True))
    cpu = lambda o: dataclasses.replace(o, **{
        f.name: getattr(o, f.name).cpu() for f in dataclasses.fields(o)
        if isinstance(getattr(o, f.name), torch.Tensor)})
    for byband in (False, True):
        n0, m0 = lw_2stream.launches, lw_noscat.launches
        got = rte_lw(props, src, inp.sfc_emis, use_2stream=True,
                     byband=byband)
        torch.cuda.synchronize()
        assert (lw_2stream.launches, lw_noscat.launches) == (n0 + 1, m0)
        ref = rte_lw(cpu(props), cpu(src), inp.sfc_emis.cpu(),
                     use_2stream=True, byband=byband)
        _close((got.flux_up.cpu(), got.flux_dn.cpu()),
               (ref.flux_up, ref.flux_dn), 2e-6)


def test_secant_forms_agree_on_card(cuda):
    """A tuple of floats, a 0-d tensor, a 1-D tensor and a tuple holding a
    0-d tensor give bit-identical fluxes on the card (one kernel launch
    each); a 0-d secant that requires grad gets a finite gradient."""
    from rte_rrtmgp_tpu_torch.ops.solver_lw import lw_solver_noscat
    p = build_allsky(*DIMS["g24"], device=cuda)
    inp = p.inputs
    props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                        inp.tsfc, inp.gas_concs,
                                        tlev=inp.tlev)
    emis = inp.sfc_emis.expand(-1, props.tau.shape[2]).contiguous()
    args = (props.tau, src.lay_source, src.lev_source, emis, src.sfc_source,
            torch.zeros_like(emis))
    kw = dict(top_at_1=True, weights=(0.5,))
    d = torch.tensor(1.66, device=cuda)
    outs = []
    for ds in ((1.66,), d, d[None], (d,)):
        n0 = lw_noscat.launches
        outs.append(lw_solver_noscat(*args, ds=ds, **kw))
        assert lw_noscat.launches == n0 + 1
    for f in outs[1:]:
        assert torch.equal(f.flux_up, outs[0].flux_up)
        assert torch.equal(f.flux_dn, outs[0].flux_dn)
    dg = d.clone().requires_grad_()
    f = lw_solver_noscat(*args, ds=(dg,), **kw)
    assert torch.equal(f.flux_up, outs[0].flux_up)
    g, = torch.autograd.grad(f.flux_up.sum(), dg)
    assert bool(torch.isfinite(g)) and float(g) != 0.0


def test_new_wrappers_refuse_float64_and_grad(cuda):
    """The two-stream kernel and the by-band solvers take float32 only,
    and the raw two-stream wrapper refuses an input that requires grad;
    nothing is launched."""
    p = build_allsky(*DIMS["g32"], device=cuda)
    args = _lw2_args(p, cuda)
    ngpt = args[0].shape[2]
    gpt2band, nband = _bands(ngpt, 4, "uniform", cuda)
    counts = [f.launches for f in (lw_2stream, lw_noscat, sw_2stream)]
    f64 = tuple(a.double() for a in args)
    with pytest.raises(ValueError, match="dtype"):
        lw_2stream(*f64)
    with pytest.raises(ValueError, match="dtype"):
        lw_2stream(*f64, gpt2band, nband=nband)
    with pytest.raises(ValueError, match="dtype"):
        lw_noscat(f64[0], *f64[3:5], f64[5], f64[6], f64[7], ds=1.66,
                  weight=1.0, gpt2band=gpt2band, nband=nband)
    with pytest.raises(ValueError, match="no backward"):
        lw_2stream(args[0].detach().clone().requires_grad_(), *args[1:])
    assert [f.launches for f in (lw_2stream, lw_noscat, sw_2stream)] \
        == counts
