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
two-stream path's launches, and the secant forms on the card. The fused
SW kernel and the LW two-stream kernel, which hold their layer fields on
chip in clusters of chunks (ops/kernels/onchip.py), also at the paths'
widths (the flagship 224 / 256 g-points and the non-banded 168 / 192, not
multiples of 32 per column), by band with uniform and ragged bands, with
a diffuse incident flux under night and low suns, in the tallest column
their narrowest chunk holds (one layer more raises) and bit-identical
over two runs; the fused LW kernel likewise on chip, broadband, by band,
with an incident flux and without clouds; the LW no-scattering solver
likewise on chip, its three launchers in every variant (as the public
path calls it, by band, rescaled with the Jacobian and a secant field;
the lane layout plain and rescaled; the in-kernel Planck sources with and
without cloud), in the tallest column each variant holds (one layer more
raises). The minor-gas scaling rows of every window in one launch, at
the paths' shapes (all-sky 4096 x 72 with the flagship LW and SW
k-distributions, RFMIP's 1800 x 60) in both layouts (the fused gas
optics' transposed views read through their strides), bit for bit the
twins' rows, and so the fused fluxes bit for bit those on the twins'
rows; their adjoint within 1e-5 of the float64 twin's autograd, the same
bits twice, once per gas-optics call of a gradient step. The gas-optics
descriptors (column amounts and interpolation coefficients) in one launch
at the same shapes and the whole-grid stream's ragged 1,120-column chunk,
in both layouts, with fields, profiles, host and device scalars, float64
vmrs and a given col_dry: bit for bit the twins', and the fused fluxes on
them bit for bit those on the twins'; their adjoint within 1e-6 of the
float64 twin's autograd, the same bits twice, once per gas-optics call of
a gradient step; the fused step with the value checks off makes no host
wait, and with them on its SW call makes none after the LW call on the
same cloud fields (also in a gradient step) but reads again, and raises,
after an in-place change of them. The minor-gas
gather in place and out of place (the public
paths' call), on both atmospheres and with a scaling row of zeros; the
major-gas gather from the interleaved LW table at the paths' widths; and
the rewritten kernels (rows 2, 4, 5, 7, 10, 11) with the kernels that
share device code with them (rows 3, 6, 16) bit for bit the outputs
recorded from them before (tests/golden/kernel_digests_frozen.json; row
11 its rewritten kernel's). The RFMIP driver's and SSM's shapes: rows 2
and 3 at 61 layers with a per-column TSI incident flux and night columns,
rows 7 and 9 at SSM's 41 g-points; the RFMIP block loop against one
launch; the pod-scale stream against the resident chunk, bit for bit.
The whole-grid stream at ne30pg2's 21,600 x 72 and the flagship widths:
every sweep's LW bit for bit the fused step run resident on each chunk,
its SW likewise on each chunk's day columns and 0 at night, its counts
and launches; its readbacks wait for each chunk's step; the same with
MERRA aerosols, their lookup once per gas-optics call and one host wait
a sweep. The aerosol lookup kernel at 4096 x 72 in its three modes
against its float32 and float64 twins. The paths: in
float32 on the card against float64 at the production configuration
(256 x 72; the fused step, the public API and the staged branch against
tests/golden/production.npz, the aerosols step and the LW two-stream path
against their float64 twins on the CPU, each within 3x its float32 noise
floor; the RFMIP driver against tests/golden/rfmip.npz within 3x its
float32 twin's distance); the fused step's d(TOA LW up)/d(tsfc) against
the analytic surface Jacobian; every path at 4096 x 72 with each kernel's
launches and against the fused step (or its broadband run) within rtol
3e-5 / atol 5e-4 W/m2; the RFMIP driver's fused, generic and SSM routes
at 1800 x 61; rte_lw's Gauss and optimal angles against the CPU twins;
each kernel's shared memory, occupancy and scratch at the main shapes.

This file is the pass/fail gate on the card. ``chip_smoke.py`` prints the
kernel table (each kernel at its path's shapes, its error, time and
bound); the paths' times, launches and idle share are the benchmark's
(``torch_bench/``, ``scripts/torch_trace_breakdown.py``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_lw_inputs, allsky_staged_lw,
    allsky_staged_sw, allsky_step_lw, allsky_step_sw, allsky_sw_inputs,
    build_allsky, build_allsky_step)
from rte_rrtmgp_tpu_torch.drivers.rfmip import synthetic_rfmip  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.aerosol_props import (  # noqa: E402
    aerosol_props, aerosol_props_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (  # noqa: E402
    cloud_props, cloud_props_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    lw_fused, lw_fused_bwd, lw_fused_bwd_plain, lw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused, sw_fused_bwd, sw_fused_bwd_plain, sw_fused_plain)
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    vmr_rows)
from rte_rrtmgp_tpu_torch.ops.gas_optics import InterpCoeffs  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.gas_descriptors import (  # noqa: E402
    gas_descriptors, gas_descriptors_bwd, gas_descriptors_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (  # noqa: E402
    gas_major, gas_major_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (  # noqa: E402
    gas_minor, gas_minor_plain, gas_rayleigh, gas_rayleigh_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.minor_scale import (  # noqa: E402
    minor_scale, minor_scale_bwd, minor_scale_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.onchip import (  # noqa: E402
    onchip_geometry)
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
# every hand-written kernel's launch counter, by its row's name in
# chip_smoke.py's kernel table
KERNELS = {"cloud_props": cloud_props, "fused_lw": lw_fused,
           "fused_sw": sw_fused, "gas_major": gas_major,
           "gas_minor": gas_minor, "gas_rayleigh": gas_rayleigh,
           "solver_lw": lw_noscat, "solver_sw": sw_2stream,
           "solver_lw_lanes": lw_noscat_lanes,
           "solver_lw_pfrac": lw_noscat_lanes_pfrac,
           "solver_sw_lanes": sw_2stream_lanes,
           "solver_sw_combined": sw_2stream_lanes_combined,
           "solver_lw_2str": lw_2stream, "fused_lw_bwd": lw_fused_bwd,
           "fused_sw_bwd": sw_fused_bwd, "solver_lw_bwd": lw_noscat_bwd,
           "solver_sw_bwd": sw_2stream_bwd, "minor_scale": minor_scale,
           "minor_scale_bwd": minor_scale_bwd,
           "gas_descriptors": gas_descriptors,
           "gas_descriptors_bwd": gas_descriptors_bwd,
           "aerosol_props": aerosol_props}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launches(fn):
    """fn's result and how often it launched each kernel of KERNELS."""
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in KERNELS.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches - before[k] for k, f in KERNELS.items()}


def _assert_launches(got, exact, launched=()):
    """Each kernel in ``exact`` (name -> launches) launched so many times,
    each in ``launched`` at least once, no other."""
    for k, n in got.items():
        if k in exact:
            assert n == exact[k], (k, n, exact[k])
        elif k in launched:
            assert n > 0, k
        else:
            assert n == 0, (k, n)


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
                gas.gpoint_flavor, gas.kmajor_pfrac)
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


# the paths' main shapes (chip_smoke.py's MAIN): the all-sky problem at
# 4096 x 72 with the flagship LW and SW k-distributions, and the
# non-banded configuration (bands of 12 g-points) at the same size; the
# minor-gas scaling rows at the first and at RFMIP's cells (100 sites x
# 18 experiments x 60 layers) through the same gas optics
MAIN = (4096, 72, 256, 16, 224, 14, 14, 59)
MAIN_NONBANDED = (4096, 72, 192, 16, 168, 14, 14, 59)


@pytest.fixture(scope="module")
def scale_cases():
    """(label, gas optics, tropo, play, tlay, col_gas, idx_h2o) for each
    shape, k-distribution and layout: the public (ncol, nlay) cells and
    the fused gas optics' layer-major views (play.T,
    col_gas.transpose(1, 2)), as the two routes hand them over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    p = build_allsky(*MAIN, device=dev)
    rf = synthetic_rfmip(nsite=100, nlay=60, nexp=18).device_inputs(
        dev, torch.float32)
    cases = []
    for shape, (play, plev, tlay, concs) in (
            ("allsky", (p.inputs.play, p.inputs.plev, p.inputs.tlay,
                        p.inputs.gas_concs)),
            ("rfmip", (rf["play"], rf["plev"], rf["tlay"],
                       rf["gas_concs"]))):
        for band, gas in (("lw", p.gas_lw), ("sw", p.gas_sw)):
            cg, _, h2o = gas.col_gas(play, plev, concs)
            for layout in ("public", "fused"):
                x = ((play, tlay, cg) if layout == "public"
                     else (play.T, tlay.T, cg.transpose(1, 2)))
                tropo = gas.interp(*x).tropo
                cases.append((f"{shape} {band} {layout}", gas, tropo, *x,
                              h2o))
    return cases


def _scale_twins(gas, tropo, play, tlay, cg, h2o):
    """The two atmospheres' minor_scaling twins, concatenated."""
    kd = gas.kdist
    co = gas.interp(play, tlay, cg)._replace(tropo=tropo)
    kw = dict(play=play, tlay=tlay, col_gas=cg, idx_h2o=h2o)
    return torch.cat([minor_scaling(co, kd.minor_lower, lower=True, **kw),
                      minor_scaling(co, kd.minor_upper, lower=False, **kw)])


def test_minor_scale_matches_twins_bit_for_bit(scale_cases):
    for label, gas, tropo, play, tlay, cg, h2o in scale_cases:
        n0 = minor_scale.launches
        got = minor_scale(tropo, play, tlay, cg, h2o, gas.minor_windows,
                          gas.minor_scale_table)
        assert minor_scale.launches == n0 + 1, label
        ref = _scale_twins(gas, tropo, play, tlay, cg, h2o)
        assert got.is_contiguous() and got.shape == ref.shape, label
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (
            label, float((got - ref).abs().max()))


def test_minor_scale_float64_matches_twin(cuda):
    p = build_allsky(*DIMS["g24"], device=cuda, dtype=torch.float64)
    inp = p.inputs
    for gas in (p.gas_lw, p.gas_sw):
        cg, _, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
        x = (inp.play.T, inp.tlay.T, cg.transpose(1, 2))
        tropo = gas.interp(*x).tropo
        got = minor_scale(tropo, *x, h2o, gas.minor_windows,
                          gas.minor_scale_table)
        assert torch.equal(got, _scale_twins(gas, tropo, *x, h2o))


def test_minor_scale_adjoint_matches_f64_twin(scale_cases):
    """The adjoint's col_gas, play and tlay cotangents against autograd of
    the twin in float64, on seeded cotangents: within 1e-5 of each
    gradient's largest value; the same bits twice."""
    for i, (label, gas, tropo, play, tlay, cg, h2o) in enumerate(
            scale_cases):
        gen = torch.Generator(device=play.device).manual_seed(20 + i)
        g = torch.randn((len(gas.minor_windows),) + tuple(play.shape),
                        generator=gen, device=play.device)
        args = (tropo, play, tlay, cg, h2o, gas.minor_windows,
                gas.minor_scale_table, g)
        n0 = minor_scale_bwd.launches
        got = minor_scale_bwd(*args)
        again = minor_scale_bwd(*args)
        assert minor_scale_bwd.launches == n0 + 2, label
        assert all(torch.equal(a, b) for a, b in zip(got, again)), label
        assert got[0].stride() == cg.stride(), label
        x = [t.detach().double().requires_grad_() for t in (cg, play, tlay)]
        rows = minor_scale_plain(tropo, x[1], x[2], x[0], h2o,
                                 gas.minor_windows)
        want = torch.autograd.grad(rows, x, g.double())
        del rows, x
        for name, a, b in zip(("col_gas", "play", "tlay"), got, want):
            scale = float(b.abs().max())
            err = float((a.double() - b).abs().max())
            assert bool(torch.isfinite(a).all()) and err <= 1e-5 * scale, (
                label, name, err / scale)
        del got, again, want
    torch.cuda.empty_cache()


def test_fused_fluxes_on_kernel_rows_equal_twin_rows(cuda):
    """The fused LW and SW kernels on the rows from the kernel and on the
    twins' rows: the same fluxes, bit for bit (the rows are)."""
    p = build_allsky(*MAIN, device=cuda)
    inp = p.inputs
    for inputs, gas, fused in (
            (allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw),
             p.gas_lw, lw_fused),
            (allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw),
             p.gas_sw, sw_fused)):
        cg, _, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
        twin = _scale_twins(gas, inputs.co.tropo, inp.play.T, inp.tlay.T,
                            cg.transpose(1, 2), h2o)
        got = fused(inputs)
        ref = fused(inputs._replace(minor_scale=twin.contiguous()))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    torch.cuda.empty_cache()


# the gas-optics descriptors (column amounts and interpolation
# coefficients) of one call in one launch, at the paths' shapes: the
# all-sky problem (4096 x 72, flagship LW and SW), RFMIP's cells (1800 x
# 60) and the whole-grid stream's ragged last chunk (1,120 columns)
@pytest.fixture(scope="module")
def desc_cases():
    """(label, gas optics, play, plev, tlay, gas store) per shape and
    k-distribution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    p = build_allsky(*MAIN, device=dev)
    rf = synthetic_rfmip(nsite=100, nlay=60, nexp=18).device_inputs(
        dev, torch.float32)
    inp = p.inputs
    n = 1120
    shapes = (("allsky", (inp.play, inp.plev, inp.tlay, inp.gas_concs)),
              ("rfmip", (rf["play"], rf["plev"], rf["tlay"],
                         rf["gas_concs"])),
              ("ragged", (inp.play[:n], inp.plev[:n], inp.tlay[:n],
                          inp.gas_concs.get_subset(0, n))))
    return [(f"{shape} {band}", gas, *x) for shape, x in shapes
            for band, gas in (("lw", p.gas_lw), ("sw", p.gas_sw))]


def _bits(x):
    """A tensor's bits, for comparisons that see -0 and NaN."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


def _desc_equal(got, ref, label):
    """col_gas and every coefficient bit for bit; on a mismatch, the
    field and its largest distance in ulps."""
    for name, a, b in zip(("col_gas",) + InterpCoeffs._fields,
                          (got[0], *got[1]), (ref[0], *ref[1])):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, name)
        assert a.is_contiguous(), (label, name)
        ulps = int((_bits(a).long() - _bits(b).long()).abs().max())
        assert ulps == 0, (label, name, ulps)


@pytest.mark.parametrize("layout", ["public", "fused"])
def test_gas_descriptors_match_twin_bit_for_bit(desc_cases, layout):
    for label, gas, play, plev, tlay, concs in desc_cases:
        vmrs, h2o = vmr_rows(gas.kdist, concs, *play.shape)
        args = (play, tlay, plev, vmrs, None, h2o,
                gas.interp_tables[torch.float32], layout == "fused")
        n0 = gas_descriptors.launches
        got = gas_descriptors(*args)
        assert gas_descriptors.launches == n0 + 1, label
        _desc_equal(got, gas_descriptors_plain(*args), label)


def test_gas_descriptors_gas_kinds_and_col_dry(desc_cases):
    """Gases as fields, a profile, a host scalar (a CPU float64 tensor,
    passed by value), a device scalar and a float64 field, and a given
    col_dry: bit for bit the twin's, in both layouts."""
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    label, gas, play, plev, tlay, concs = desc_cases[0]
    ncol, nlay = play.shape
    mixed = GasConcs.empty()
    for i, name in enumerate(concs.names):
        v = concs.get_vmr(name, ncol, nlay)
        v = (v.contiguous(), v[0].contiguous(),
             v[0, 0].double().cpu(), v[0, 0].clone(),
             v.double().contiguous())[i % 5]
        mixed = mixed.set_vmr(name, v)
    vmrs, h2o = vmr_rows(gas.kdist, mixed, ncol, nlay)
    assert any(v is not None and v.device.type == "cpu" for v in vmrs)
    dry = 1.01 * gas.col_gas(play, plev, concs)[1]
    for col_dry in (None, dry):
        for lm in (False, True):
            args = (play, tlay, plev, vmrs, col_dry, h2o,
                    gas.interp_tables[torch.float32], lm)
            _desc_equal(gas_descriptors(*args),
                        gas_descriptors_plain(*args), (label, lm))


def test_gas_descriptors_float64_match_twin(cuda):
    p = build_allsky(*DIMS["g24"], device=cuda, dtype=torch.float64)
    inp = p.inputs
    for gas in (p.gas_lw, p.gas_sw):
        vmrs, h2o = vmr_rows(gas.kdist, inp.gas_concs, *inp.play.shape)
        for lm in (False, True):
            args = (inp.play, inp.tlay, inp.plev, vmrs, None, h2o,
                    gas.interp_tables[torch.float64], lm)
            _desc_equal(gas_descriptors(*args),
                        gas_descriptors_plain(*args), lm)


def test_fused_fluxes_on_kernel_descriptors_equal_twin(cuda):
    """The fused LW and SW kernels on the kernel's descriptors and on the
    twin's (with the scaling rows and Rayleigh scale of the twin's
    columns): the same fluxes, bit for bit."""
    p = build_allsky(*MAIN, device=cuda)
    inp = p.inputs
    for inputs, gas, fused in (
            (allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw),
             p.gas_lw, lw_fused),
            (allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw),
             p.gas_sw, sw_fused)):
        vmrs, h2o = vmr_rows(gas.kdist, inp.gas_concs, *inp.play.shape)
        cg, co = gas_descriptors_plain(
            inp.play, inp.tlay, inp.plev, vmrs, None, h2o,
            gas.interp_tables[torch.float32], True)
        twin = dict(co=co, minor_scale=_scale_twins(
            gas, co.tropo, inp.play.T, inp.tlay.T, cg, h2o).contiguous())
        if fused is sw_fused:
            twin["rayscale"] = (cg[h2o] + cg[0]).contiguous()
        got = fused(inputs)
        ref = fused(inputs._replace(**twin))
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))
    torch.cuda.empty_cache()


@pytest.mark.parametrize("col_dry", ["computed", "given"])
def test_gas_descriptors_adjoint_matches_f64_twin(desc_cases, col_dry):
    """The adjoint's cotangents of play, tlay, plev (or a given col_dry)
    and the vmr fields against autograd of the twin in float64, on seeded
    cotangents of col_gas, ftemp, fpress, col_mix and feta: within 1e-6
    of each gradient's largest value; the same bits twice."""
    for i, (label, gas, play, plev, tlay, concs) in enumerate(desc_cases):
        ncol, nlay = play.shape
        vmrs, h2o = vmr_rows(gas.kdist, concs, ncol, nlay)
        vmrs = tuple(None if v is None else
                     v.expand(ncol, nlay).contiguous().requires_grad_()
                     for v in vmrs)
        dry = (None if col_dry == "computed" else
               gas.col_gas(play, plev, concs)[1].clone().requires_grad_())
        pl = plev.clone().requires_grad_(dry is None)
        tables, lm = gas.interp_tables[torch.float32], i % 2 == 1
        with torch.no_grad():
            cg, co = gas_descriptors(play, tlay, pl, vmrs, dry, h2o, tables,
                                     lm)
        gen = torch.Generator(device=play.device).manual_seed(30 + i)
        g = tuple(torch.randn(x.shape, generator=gen, device=play.device)
                  for x in (cg, co.ftemp, co.fpress, co.col_mix, co.feta))
        args = (play, tlay, pl, vmrs, dry, h2o, tables, lm, g)
        n0 = gas_descriptors_bwd.launches
        with torch.no_grad():
            got = gas_descriptors_bwd(*args)
            again = gas_descriptors_bwd(*args)
        assert gas_descriptors_bwd.launches == n0 + 2, label
        flat = lambda r: [r[0], r[1], r[2] if dry is None else r[3]] + [
            d for d in r[4] if d is not None]
        got, again = flat(got), flat(again)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), label
        d64 = lambda x: None if x is None else (
            x.detach().double().requires_grad_())
        x64 = [d64(play), d64(tlay), d64(plev if dry is None else dry)]
        v64 = tuple(d64(v) for v in vmrs)
        with torch.enable_grad():
            cg64, co64 = gas_descriptors_plain(
                x64[0], x64[1], x64[2] if dry is None else plev.double(),
                v64, None if dry is None else x64[2], h2o,
                gas.interp_tables[torch.float64], lm)
            want = torch.autograd.grad(
                (cg64, co64.ftemp, co64.fpress, co64.col_mix, co64.feta),
                x64 + [v for v in v64 if v is not None],
                tuple(x.double() for x in g))
        del cg64, co64
        names = ["play", "tlay", "plev" if dry is None else "col_dry"] + [
            f"vmr {k + 1}" for k, v in enumerate(vmrs) if v is not None]
        for name, a, b in zip(names, got, want):
            scale = float(b.abs().max())
            err = float((a.double() - b).abs().max())
            assert bool(torch.isfinite(a).all()) and err <= 1e-6 * scale, (
                label, name, err / scale)
        del got, again, want
    torch.cuda.empty_cache()


def test_fused_step_makes_no_host_wait(cuda):
    """With the value checks off, the fused all-sky step (LW, then SW)
    makes no host wait: torch's sync debug mode set to raise stays
    silent."""
    from rte_rrtmgp_tpu_torch.config import checks_disabled
    p = build_allsky(*MAIN, device=cuda)
    inp = p.inputs
    step = lambda: (allsky_step_lw(inp, p.gas_lw, cloud_optics=p.cld_lw),
                    allsky_step_sw(inp, p.gas_sw, cloud_optics=p.cld_sw))
    with checks_disabled():
        step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_cloud_check_reads_once_per_new_state(cuda):
    """With the value checks on, at the main shapes: the SW call after the
    LW call on the same new cloud fields makes no host wait (its cloud
    check returns on the LW call's), also in a gradient step; a change of
    rel in place between the two calls makes the SW call read again and
    raise."""
    p = build_allsky(*MAIN, device=cuda)
    fresh = lambda x: x._replace(lwp=x.lwp.clone(), iwp=x.iwp.clone(),
                                 rel=x.rel.clone(), dei=x.dei.clone())
    lw = lambda x: allsky_step_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
    sw = lambda x: allsky_step_sw(x, p.gas_sw, cloud_optics=p.cld_sw)

    def sw_without_wait(x):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return sw(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    lw(p.inputs), sw(p.inputs)
    x = fresh(p.inputs)
    lw(x)
    sw_without_wait(x)

    x = fresh(p.inputs)
    lw(x)
    x.rel.mul_(100.0)
    with pytest.raises(ValueError, match="liquid effective radius"):
        sw(x)

    x = fresh(p.inputs)
    leaves = (x.tlay.clone().requires_grad_(),
              x.rel.clone().requires_grad_())
    x = x._replace(tlay=leaves[0], rel=leaves[1])
    up = lw(x).flux_up
    out = sw_without_wait(x)
    grads = torch.autograd.grad(up.sum() + out.flux_dn.sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    torch.cuda.synchronize()


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
    out = (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir)
    for got in out:
        assert got.is_cuda and bool(torch.isfinite(got).all())
    _paths_agree(out, step(p.inputs))


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
    """d/d(tlay, tsfc, lwp, rel, h2o vmr) of the weighted flux loss of one
    step (the benchmark's gradient step's loss, torch_bench/steps/grad.py:
    level weights 0.5 to 1.5, up fluxes 1, down 0.5, the SW direct beam
    0.25)."""
    ncol, nlay = inputs.play.shape
    leaves = {k: getattr(inputs, k).detach().clone().requires_grad_()
              for k in ("tlay", "tsfc", "lwp", "rel")}
    h2o = inputs.gas_concs.get_vmr("h2o", ncol, nlay).detach().clone() \
        .requires_grad_()
    out = step(inputs._replace(
        gas_concs=inputs.gas_concs.set_vmr("h2o", h2o), **leaves))
    w = torch.linspace(0.5, 1.5, nlay + 1, device=inputs.play.device)
    loss = sum((w * f).sum() * c for f, c in zip(out, (1, 0.5, 1, 0.5)))
    loss = loss + 0.25 * out[4].sum()
    return torch.autograd.grad(loss, tuple(leaves.values()) + (h2o,))


def _composed_step(p, path, **opts):
    """One all-sky step composed from the problem's objects through the
    fused step ("step"), the public API ("api") or the staged lane-layout
    branch ("staged"): (lw_up, lw_dn, sw_up, sw_dn, sw_dn_dir); or the LW
    two-stream path ("two-stream", examples/flux_variants.py:76-82, the
    true two-stream with clouds: gas optics with scattering, the 2-stream
    cloud optics, increment, then rte_lw(use_2stream=True)): (flux_up,
    flux_dn), (ncol, nlay+1) or by band (ncol, nlay+1, nband)."""
    import rte_rrtmgp_tpu_torch.drivers.allsky as allsky
    from rte_rrtmgp_tpu_torch.rte import rte_lw

    def two_stream(i):
        props, src = p.gas_lw.gas_optics_lw(
            i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
            scattering=True, top_at_1=True)
        props = increment(props, p.cld_lw.cloud_optics(
            i.lwp, i.iwp, i.rel, i.dei, scattering=True))
        f = rte_lw(props, src, i.sfc_emis, use_2stream=True, **opts)
        return f.flux_up, f.flux_dn

    def step(i):
        lw, sw = (getattr(allsky, f"allsky_{path}_{b}")(
            i, getattr(p, f"gas_{b}"), cloud_optics=getattr(p, f"cld_{b}"),
            aerosol_optics=getattr(p, f"aer_{b}"), **opts)
            for b in ("lw", "sw"))
        return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                sw.flux_dn_dir)
    return two_stream if path == "two-stream" else step


@pytest.mark.parametrize("dims", ["g32", "main"])
@pytest.mark.parametrize("path", ["fused", "fused-aerosols", "api"])
def test_gradient_step_launches_adjoints(cuda, path, dims):
    """A gradient step, at 32 g-points and at the main shapes (4096 x 72,
    LW 256 / SW 224: the fused adjoints' blocks of 256 and 224 threads,
    as the benchmark's gradient cell runs them), launches
    each kernel of its path an exact number of times (each adjoint once,
    cloud optics once per band set, the scaling rows, the descriptors and
    their adjoints, and with aerosols their lookup, once per gas-optics
    call; the public API's gathers at least once) and no other; finite gradients, not all zero, the same
    bits twice."""
    shape = MAIN if dims == "main" else DIMS[dims]
    exact = dict(cloud_props=2, minor_scale=2, minor_scale_bwd=2,
                 gas_descriptors=2, gas_descriptors_bwd=2)
    launched = ()
    if path == "api":
        p = build_allsky(*shape, device=cuda)
        step, inputs = _composed_step(p, "api"), p.inputs
        exact.update(solver_lw=1, solver_sw=1, solver_lw_bwd=1,
                     solver_sw_bwd=1)
        launched = ("gas_major", "gas_minor", "gas_rayleigh")
    else:
        step, inputs = build_allsky_step(
            *shape, device=cuda, use_aerosols=path != "fused")
        exact.update(fused_lw=1, fused_sw=1, fused_lw_bwd=1, fused_sw_bwd=1,
                     aerosol_props=2 if path != "fused" else 0)
    grads, got = _launches(lambda: _train_grads(step, inputs))
    _assert_launches(got, exact, launched)
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
                                 p.gas_lw.gpoint_flavor,
                                 p.gas_lw.kmajor_pfrac))
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
    contiguous bands, seven contiguous bands of widths 1, 2, 3, ... and
    the rest ("uneven"), or three ragged bands whose g-points interleave
    ("ragged")."""
    if kind == "uniform":
        return torch.arange(ngpt, device=cuda, dtype=torch.int32) // (
            ngpt // nband), nband
    if kind == "uneven":
        edges = np.cumsum(np.arange(1, ngpt))
        b = np.minimum(np.searchsorted(edges, np.arange(ngpt),
                                       side="right"), 6)
        return torch.tensor(b, dtype=torch.int32, device=cuda), 7
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


# ---------------------------------------------------------------------------
# rows 3 and 8 on chip: a column's g-points in a cluster of chunks, the
# layer fields in shared memory (ops/kernels/onchip.py)
# ---------------------------------------------------------------------------

ONCHIP_CASES = {**DIMS, "flagship": FLAGSHIP, "nonbanded": NONBANDED_72}


def _flux_close(got, ref, tol=2e-6):
    """chip_smoke.py's TOL_FLUX rule (check_kernel): the largest
    difference over the kernel's outputs within tol of their largest twin
    value. Per output it does not hold at the paths' widths for the small
    up flux, for this kernel as for a kernel that keeps the layer fields
    in device memory: 2.2e-6 of the up flux's own largest value from the
    float32 twin, and nearer than that twin to the float64 twin (measured
    on an H100, PERF.md)."""
    assert all(g.shape == r.shape and g.dtype == torch.float32
               for g, r in zip(got, ref))
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    assert err <= tol * max(float(r.abs().max()) for r in ref)


def _row8_close(got, args, kw, monkeypatch):
    """Row 8 against its twin: within 2e-6 of the float32 twin's largest
    flux, or, where float32 cannot resolve the Toon sources just above
    tau 1e-8, no further than TOL_COND times the float32 twin from the
    float64 twin (chip_smoke.py's rule for this kernel)."""
    ref = lw_2stream_plain(*args, **kw)
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    if err <= 2e-6 * scale:
        return
    ref64 = _twin_f64(lw_2stream_plain, args, kw, monkeypatch)
    gap = lambda xs: max(float((x.double() - r).abs().max())
                         for x, r in zip(xs, ref64))
    assert gap(got) <= TOL_COND * gap(ref)


def _tallest(kernel, ngpt, nminor=0):
    """The tallest column the kernel's chunk holds, from onchip_geometry's
    message."""
    with pytest.raises(ValueError, match="at most") as e:
        onchip_geometry(kernel, 10 ** 6, ngpt, 0, nminor)
    return int(str(e.value).split("at most ")[1].split()[0])


@pytest.mark.parametrize("output", ["broadband", "uniform", "ragged"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_lw_2stream_matches_twin(cuda, dims, output, monkeypatch):
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    args = _lw2_args(p, cuda)
    kw = {}
    if output != "broadband":
        gpt2band, nband = _bands(args[0].shape[2], ONCHIP_CASES[dims][3],
                                 output, cuda)
        args, kw = args + (gpt2band,), dict(nband=nband)
    n0 = lw_2stream.launches
    got = lw_2stream(*args, **kw)
    assert lw_2stream.launches == n0 + 1
    _row8_close(got, args, kw, monkeypatch)
    again = lw_2stream(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("variant", ["broadband", "uniform", "ragged",
                                     "incdif-low-suns"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_fused_sw_matches_twin(cuda, dims, variant):
    """By band with the k-distribution's uniform bands or three ragged,
    interleaved ones; with a diffuse incident flux under a night column,
    suns below the min_mu0 clamp and overhead ones."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    x = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
    nlay, ncol = x.mu0.shape
    if variant in ("uniform", "ragged"):
        gpt2band, nband = _bands(x.kmajor.shape[3], ONCHIP_CASES[dims][5],
                                 variant, cuda)
        x = x._replace(gpt2band=gpt2band, nband=nband, byband=True)
    elif variant == "incdif-low-suns":
        mu = torch.tensor([0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86, 0.99,
                           1.0], device=cuda)[torch.arange(ncol) % 10]
        gen = torch.Generator(device=cuda).manual_seed(12)
        x = x._replace(
            mu0=mu[None, :].expand(nlay, ncol).contiguous(),
            incdif=0.05 * x.inc * torch.rand(x.inc.shape, generator=gen,
                                             device=cuda))
    n0 = sw_fused.launches
    got = sw_fused(x)
    assert sw_fused.launches == n0 + 1
    _flux_close(got, sw_fused_plain(x))
    again = sw_fused(x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_onchip_tallest_column_and_past_it(cuda, monkeypatch):
    """The tallest column that the narrowest chunk (32 g-points) holds, on
    both kernels against their twins; one layer more raises ValueError
    and launches nothing."""
    ngpt = 32
    nlay = _tallest("lw_2stream", ngpt)
    rng = np.random.default_rng(13)
    u = lambda lo, hi, *s: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    ncol = 3
    args = (u(0.0, 0.2, ncol, nlay, ngpt), u(0.0, 0.9, ncol, nlay, ngpt),
            u(0.0, 0.8, ncol, nlay, ngpt), u(50.0, 100.0, ncol, nlay, ngpt),
            u(50.0, 100.0, ncol, nlay + 1, ngpt), u(0.8, 1.0, ncol, ngpt),
            u(50.0, 100.0, ncol, ngpt), u(0.0, 2.0, ncol, ngpt))
    _row8_close(lw_2stream(*args), args, {}, monkeypatch)
    taller = tuple(torch.cat([a, a[:, :1]], 1) if a.dim() == 3 else a
                   for a in args)
    n0 = lw_2stream.launches
    with pytest.raises(ValueError, match=f"at most {nlay} layers"):
        lw_2stream(*taller)
    assert lw_2stream.launches == n0

    dims = DIMS["g32"]
    p = build_allsky(2, 8, *dims[2:], device=cuda)
    nminor = len(allsky_sw_inputs(p.inputs, p.gas_sw,
                                  cloud_optics=p.cld_sw).minors)
    nlay = _tallest("fused_sw", dims[4], nminor)
    for n, fits in ((nlay, True), (nlay + 1, False)):
        p = build_allsky(2, n, *dims[2:], device=cuda)
        x = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
        n0 = sw_fused.launches
        if fits:
            _flux_close(sw_fused(x), sw_fused_plain(x))
            assert sw_fused.launches == n0 + 1
        else:
            with pytest.raises(ValueError, match=f"at most {nlay} layers"):
                sw_fused(x)
            assert sw_fused.launches == n0


# ---------------------------------------------------------------------------
# rows 9, 12, 13 and 15 on chip: the SW solver's three launchers and its
# adjoint, a column's g-points in a cluster of chunks, the layer fields in
# shared memory (ops/kernels/onchip.py); row 17 unchanged
# ---------------------------------------------------------------------------

def _sw_pub_args(p, cuda, low_suns=False, diffuse=False, seed=14):
    """Row 9's inputs on the public path: gas optics with the
    delta-scaled clouds, the path's mu0 or (``low_suns``) a night column
    and suns down to 1e-4 varying by layer, seeded albedos, the TOA flux
    and (``diffuse``) a diffuse one."""
    inp = p.inputs
    props, toa = p.gas_sw.gas_optics_sw(inp.play, inp.plev, inp.tlay,
                                        inp.gas_concs, top_at_1=True)
    props = increment(props, delta_scale(p.cld_sw.cloud_optics(
        inp.lwp, inp.iwp, inp.rel, inp.dei)))
    ncol, nlay, ngpt = props.tau.shape
    if low_suns:
        mu = torch.tensor([-0.3, 0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6,
                           0.86, 1.0], device=cuda)[torch.arange(ncol) % 10]
        mu0 = mu[:, None] * torch.linspace(1.0, 0.95, nlay, device=cuda)
    else:
        mu0 = inp.mu0[:, None].expand(ncol, nlay)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    inc = toa.contiguous()
    c = lambda x: x.contiguous()
    return (c(props.tau), c(props.ssa), c(props.g), c(mu0),
            0.3 * rand(ncol, ngpt), 0.3 * rand(ncol, ngpt), inc,
            0.05 * inc if diffuse else None)


@pytest.mark.parametrize("variant", ["broadband", "uniform", "uneven",
                                     "ragged", "incdif-low-suns"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_sw_2stream_matches_twin(cuda, dims, variant):
    """Row 9, broadband and by band (the k-distribution's uniform bands,
    uneven contiguous ones, three interleaved ones), and with a diffuse
    incident flux under a night column and low suns: against the twin
    (chip_smoke.py's TOL_FLUX rule), band sums against the broadband
    fluxes, the same bits twice."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    low = variant == "incdif-low-suns"
    args = _sw_pub_args(p, cuda, low_suns=low, diffuse=low)
    kw = {}
    if variant in ("uniform", "uneven", "ragged"):
        gpt2band, nband = _bands(args[0].shape[2], ONCHIP_CASES[dims][5],
                                 variant, cuda)
        args, kw = args + (gpt2band,), dict(nband=nband)
    n0 = sw_2stream.launches
    got = sw_2stream(*args, **kw)
    assert sw_2stream.launches == n0 + 1
    _flux_close(got, sw_2stream_plain(*args, **kw))
    if kw:
        assert got[0].shape[2] == kw["nband"]
        _flux_close(tuple(x.sum(-1) for x in got), sw_2stream(*args[:-1]))
    again = sw_2stream(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("variant", ["plain", "plain-incdif", "combined",
                                     "combined-cloud"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_sw_lanes_match_twins(cuda, dims, variant):
    """Rows 12 and 13 on the staged path's lane inputs (permuted views of
    the gathers' output), night and low suns varying by layer: row 12
    with and without a diffuse incident flux, row 13 without and with the
    by-band cloud and aerosols; against the twins (TOL_FLUX rule), the
    same bits twice."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import _scattering_lanes
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda, use_aerosols=True)
    inp = p.inputs
    combined = variant.startswith("combined")
    tau, second, _ = p.gas_sw.gas_optics_sw_lanes(
        inp.play, inp.plev, inp.tlay, inp.gas_concs,
        split_rayleigh=combined)
    ngpt, nlay, ncol = tau.shape
    mu0, adir, adif, toa, dif = _sw_bounds(p, cuda, ngpt, nlay, ncol)
    if combined:
        cld = (_scattering_lanes(inp, p.cld_sw, True, p.aer_sw, True)
               if variant == "combined-cloud" else None)
        kernel, plain = sw_2stream_lanes_combined, \
            sw_2stream_lanes_combined_plain
        args = (tau, second, cld, mu0, adir, adif, toa, dif)
        kw = dict(gpt2band=p.gas_sw.gpt2band)
    else:
        gen = torch.Generator(device=cuda).manual_seed(16)
        g = 0.85 * torch.rand((ngpt, nlay, ncol), generator=gen,
                              device=cuda)
        kernel, plain = sw_2stream_lanes, sw_2stream_lanes_plain
        args = (tau, second, g, mu0, adir, adif, toa,
                dif if variant == "plain-incdif" else None)
        kw = {}
    n0 = kernel.launches
    got = kernel(*args, **kw)
    assert kernel.launches == n0 + 1
    _flux_close(got, plain(*args, **kw))
    again = kernel(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("ngpt", [32, 224])
def test_onchip_sw_tallest_column_and_past_it(cuda, monkeypatch, ngpt):
    """The tallest column that a 32-wide chunk holds, in one chunk and in
    the flagship's cluster of 7 (224 g-points), on the SW solver's three
    launchers and its adjoint, against the twins
    (fluxes by the TOL_FLUX rule; each cotangent within TOL_ADJ of its
    largest twin value, or, where the float32 twin misses that against
    the float64 twin, within TOL_ADJ of the float64 twin's, the rule of
    test_adjoint_kernels_match_twins); one layer more raises ValueError
    naming the limit and launches nothing."""
    ncol = 3
    rng = np.random.default_rng(15)
    u = lambda lo, hi, *s: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)

    # mu0 in [0.2, 0.3]: k mu0 below 0.6, away from the clamp at k mu0 = 1
    # (test_onchip_sw_2stream_bwd_tallest_column_near_clamp holds it there)
    def args(nlay):
        inc = u(0.5, 2.0, ncol, ngpt)
        return (u(0.0, 0.1, ncol, nlay, ngpt), u(0.0, 0.9, ncol, nlay, ngpt),
                u(0.0, 0.8, ncol, nlay, ngpt), u(0.2, 0.3, ncol, nlay),
                u(0.0, 0.3, ncol, ngpt), u(0.0, 0.3, ncol, ngpt), inc,
                0.05 * inc)

    def lanes(a):
        return (tuple(x.permute(2, 1, 0) for x in a[:3]) + (a[3].T,)
                + tuple(x.T for x in a[4:]))

    g2b = torch.zeros(ngpt, dtype=torch.int32, device=cuda)

    def combined(la):
        cloud = tuple(x[:1] for x in la[:3])
        return (la[0], la[1], cloud) + la[3:]

    nlay = _tallest("solver_sw", ngpt)
    for n, fits in ((nlay, True), (nlay + 1, False)):
        a = args(n)
        cases = ((sw_2stream, sw_2stream_plain, a, {}),
                 (sw_2stream_lanes, sw_2stream_lanes_plain, lanes(a), {}),
                 (sw_2stream_lanes_combined, sw_2stream_lanes_combined_plain,
                  combined(lanes(a)), dict(gpt2band=g2b)))
        for kernel, plain, x, kw in cases:
            n0 = kernel.launches
            if fits:
                _flux_close(kernel(*x, **kw), plain(*x, **kw))
                assert kernel.launches == n0 + 1
            else:
                with pytest.raises(ValueError,
                                   match=f"at most {nlay} layers"):
                    kernel(*x, **kw)
                assert kernel.launches == n0

    nlay = _tallest("solver_sw_bwd", ngpt)
    for n, fits in ((nlay, True), (nlay + 1, False)):
        a = args(n) + tuple(u(0.5, 1.5, ncol, n + 1) for _ in range(3))
        n0 = sw_2stream_bwd.launches
        if fits:
            got, ref = sw_2stream_bwd(*a), sw_2stream_bwd_plain(*a)
            assert sw_2stream_bwd.launches == n0 + 1
            ref64 = None
            for i, (g, r) in enumerate(zip(got, ref)):
                if float((g - r).abs().max()) <= (
                        TOL_ADJ * float(r.abs().max())):
                    continue
                if ref64 is None:
                    ref64 = _twin_f64(sw_2stream_bwd_plain, a, {},
                                      monkeypatch)
                k64, t64 = _against_f64(got, ref, ref64, i)
                assert t64 > TOL_ADJ and k64 <= TOL_ADJ, f"cotangent {i}"
        else:
            with pytest.raises(ValueError, match=f"at most {nlay} layers"):
                sw_2stream_bwd(*a)
            assert sw_2stream_bwd.launches == n0


def test_onchip_lw_noscat_bwd_tallest_column_and_past_it(cuda, monkeypatch):
    """Row 14 in the tallest column that a 32-wide chunk holds, at the
    flagship's 256 g-points (8 chunks), at 32 and in a single chunk with
    idle lanes (24 g-points), seeded optical depths
    from 1e-6 to 10, sources and flux cotangents, against the twin's
    autograd (each cotangent within TOL_ADJ of its largest twin value, or
    the float64 twin's rule of test_adjoint_kernels_match_twins); one
    layer more raises ValueError naming the limit and launches
    nothing."""
    ncol = 3
    rng = np.random.default_rng(16)
    u = lambda lo, hi, *s: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    kw = dict(ds=1.66, weight=0.5)
    for ngpt in (256, 32, 24):
        nlay = _tallest("solver_lw_bwd", ngpt)
        for n, fits in ((nlay, True), (nlay + 1, False)):
            lay3 = (ncol, n, ngpt)
            tau = torch.from_numpy((10.0 ** rng.uniform(-6.0, 1.0, lay3))
                                   .astype(np.float32)).to(cuda)
            a = (tau, u(0.5, 1.5, *lay3), u(0.5, 1.5, ncol, n + 1, ngpt),
                 u(0.8, 1.0, ncol, ngpt), u(0.5, 1.5, ncol, ngpt),
                 u(0.0, 0.5, ncol, ngpt), u(0.5, 1.5, ncol, n + 1),
                 u(0.5, 1.5, ncol, n + 1))
            n0 = lw_noscat_bwd.launches
            if not fits:
                with pytest.raises(ValueError,
                                   match=f"at most {nlay} layers"):
                    lw_noscat_bwd(*a, **kw)
                assert lw_noscat_bwd.launches == n0
                continue
            got, ref = lw_noscat_bwd(*a, **kw), lw_noscat_bwd_plain(*a, **kw)
            assert lw_noscat_bwd.launches == n0 + 1
            ref64 = None
            for i, (g, r) in enumerate(zip(got, ref)):
                if float((g - r).abs().max()) <= (
                        TOL_ADJ * float(r.abs().max())):
                    continue
                if ref64 is None:
                    ref64 = _twin_f64(lw_noscat_bwd_plain, a, kw,
                                      monkeypatch)
                k64, t64 = _against_f64(got, ref, ref64, i)
                assert t64 > TOL_ADJ and k64 <= TOL_ADJ, f"cotangent {i}"


@pytest.mark.parametrize("ngpt", [32, 224])
def test_onchip_sw_2stream_bwd_tallest_column_near_clamp(cuda, monkeypatch,
                                                         ngpt):
    """Row 15 in the tallest column that a 32-wide chunk holds (one chunk;
    the flagship's cluster of 7 at 224 g-points), mu0 per
    layer in [0.3, 0.9], so that k mu0 reaches the clamp at 1: each
    cotangent within TOL_ADJ of its largest twin value, or, where the
    float32 twin itself misses TOL_ADJ against the float64 twin (there the
    ssa, g and mu0 cotangents), within TOL_COND times the float32 twin's
    distance from the float64 twin (test_sw_solver_adjoint_low_suns's
    rule)."""
    ncol = 3
    rng = np.random.default_rng(16)
    u = lambda lo, hi, *s: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    nlay = _tallest("solver_sw_bwd", ngpt)
    inc = u(0.5, 2.0, ncol, ngpt)
    a = (u(0.0, 0.1, ncol, nlay, ngpt), u(0.0, 0.9, ncol, nlay, ngpt),
         u(0.0, 0.8, ncol, nlay, ngpt), u(0.3, 0.9, ncol, nlay),
         u(0.0, 0.3, ncol, ngpt), u(0.0, 0.3, ncol, ngpt), inc,
         0.05 * inc) + tuple(u(0.5, 1.5, ncol, nlay + 1) for _ in range(3))
    got, ref = sw_2stream_bwd(*a), sw_2stream_bwd_plain(*a)
    ref64 = None
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        if float((g - r).abs().max()) <= TOL_ADJ * float(r.abs().max()):
            continue
        if ref64 is None:
            ref64 = _twin_f64(sw_2stream_bwd_plain, a, {}, monkeypatch)
        k64, t64 = _against_f64(got, ref, ref64, i)
        assert t64 > TOL_ADJ and k64 <= TOL_COND * t64, f"cotangent {i}"


@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_sw_2stream_bwd_low_suns(cuda, dims, monkeypatch):
    """Row 15 with a diffuse incident flux under a night column and suns
    down to 1e-4 varying by layer, at the DIMS, flagship and non-banded
    widths: each cotangent within TOL_ADJ of its largest twin value, or,
    where the float32 twin itself misses that (the ssa, g and mu0
    cotangents under low suns), within TOL_COND times the float32 twin's
    distance from the float64 twin (test_sw_solver_adjoint_low_suns's
    rule); the same bits twice."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    a = _sw_pub_args(p, cuda, low_suns=True, diffuse=True, seed=18)
    ncol, nlay = a[3].shape
    gen = torch.Generator(device=cuda).manual_seed(19)
    args = a + tuple(0.5 + torch.rand((ncol, nlay + 1), generator=gen,
                                      device=cuda) for _ in range(3))
    n0 = sw_2stream_bwd.launches
    got = sw_2stream_bwd(*args)
    assert sw_2stream_bwd.launches == n0 + 1
    ref = sw_2stream_bwd_plain(*args)
    ref64 = None
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        if float((g - r).abs().max()) <= TOL_ADJ * float(r.abs().max()):
            continue
        assert i in (1, 2, 3), f"cotangent {i}"
        if ref64 is None:
            ref64 = _twin_f64(sw_2stream_bwd_plain, args, {}, monkeypatch)
        k64, t64 = _against_f64(got, ref, ref64, i)
        assert t64 > TOL_ADJ and k64 <= TOL_COND * t64, f"cotangent {i}"
    again = sw_2stream_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_fused_sw_bwd_matches_frozen_record(cuda):
    """Row 17 (csrc/fused_sw_bwd.cu), which shares transport_bwd.cuh and
    transport.cuh with the SW solver and its adjoint, gives bit for bit
    the outputs recorded from it before those two moved on chip
    (tests/golden/fused_sw_bwd_frozen.npz: fused_sw_bwd_record.record,
    written by scripts/freeze_fused_sw_bwd.py). The bits are those of one
    CUDA compiler and runtime: after a change of either, the record is
    written again on the card from a checkout whose fused SW adjoint is
    known good."""
    import os
    from fused_sw_bwd_record import record
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rec = np.load(os.path.join(root, "tests", "golden",
                               "fused_sw_bwd_frozen.npz"))
    got = record(cuda)
    assert sorted(got) == sorted(rec.files)
    for k, v in got.items():
        assert v.dtype == rec[k].dtype and v.shape == rec[k].shape, k
        assert v.tobytes() == rec[k].tobytes(), k


# ---------------------------------------------------------------------------
# row 2 on chip: the fused LW step in a cluster of chunks, the layer fields
# in shared memory (ops/kernels/onchip.py); row 5 many cells per block,
# out of place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["broadband", "uniform", "ragged", "inc",
                                     "clear"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_fused_lw_matches_twin(cuda, dims, variant):
    """By band with the k-distribution's uniform bands or three ragged,
    interleaved ones (gpt2band also picks the Planck and cloud bands, for
    kernel and twin alike); with an incident flux; without clouds; within
    chip_smoke.py's TOL_FLUX rule and bit-identical over two runs."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    x = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
    if variant in ("uniform", "ragged"):
        gpt2band, _ = _bands(x.kmajor.shape[3], ONCHIP_CASES[dims][3],
                             variant, cuda)
        x = x._replace(gpt2band=gpt2band, byband=True)
    elif variant == "inc":
        gen = torch.Generator(device=cuda).manual_seed(23)
        x = x._replace(inc=3.0 * torch.rand(x.inc.shape, generator=gen,
                                            device=cuda))
    elif variant == "clear":
        x = x._replace(cloud_tau_abs=None)
    n0 = lw_fused.launches
    got = lw_fused(x)
    assert lw_fused.launches == n0 + 1
    _flux_close(got, lw_fused_plain(x))
    again = lw_fused(x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["broadband", "byband", "flagship-inc"])
def test_onchip_fused_lw_tallest_column_and_past_it(cuda, case):
    """The tallest column that the narrowest chunk (32 g-points) holds,
    and, at the flagship's 256 g-points (a cluster of 8 chunks), with a
    seeded incident flux, on 4 columns: against the twin; one layer more
    raises ValueError naming the limit and launches nothing."""
    byband = case == "byband"
    ncol, dims = (4, MAIN) if case == "flagship-inc" else (2, DIMS["g32"])
    p = build_allsky(ncol, 8, *dims[2:], device=cuda)
    x = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
    nband = x.totplnk.shape[1] if byband else 0
    with pytest.raises(ValueError, match="at most") as e:
        onchip_geometry("fused_lw", 10 ** 6, dims[2], nband, len(x.minors))
    nlay = int(str(e.value).split("at most ")[1].split()[0])
    for n, fits in ((nlay, True), (nlay + 1, False)):
        p = build_allsky(ncol, n, *dims[2:], device=cuda)
        x = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
        x = x._replace(byband=byband)
        if case == "flagship-inc":
            gen = torch.Generator(device=cuda).manual_seed(22)
            x = x._replace(inc=0.5 + torch.rand(x.inc.shape, generator=gen,
                                                device=cuda))
        n0 = lw_fused.launches
        if fits:
            _flux_close(lw_fused(x), lw_fused_plain(x))
            assert lw_fused.launches == n0 + 1
        else:
            with pytest.raises(ValueError, match=f"at most {nlay} layers"):
                lw_fused(x)
            assert lw_fused.launches == n0


@pytest.mark.parametrize("split", [False, True], ids=["ssa", "split"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_gas_rayleigh_out_of_place_matches_twin(cuda, dims, split):
    """The Rayleigh gather as the gas optics call it (``_rayleigh``): from
    tau with ssa, or from no tau without (the split variant, 0 +
    Rayleigh): within 1e-6 of the twin's largest value, tau untouched,
    bit for bit the in-place call (on tau, or on a zeros tensor), and
    bit-identical over two runs."""
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import _rayleigh
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    gas = p.gas_sw
    co, cg, dry, h2o = _descriptors(p, gas)
    kd = gas.kdist
    tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
    args = (co, kd.krayl, gas.gpoint_flavor, (cg[h2o] + dry).contiguous(),
            not split)
    src = None if split else tau
    before = tau.clone()
    n0 = gas_rayleigh.launches
    got = _rayleigh(src, *args)
    assert gas_rayleigh.launches == n0 + 1
    assert torch.equal(tau, before)
    base = torch.zeros_like(tau) if split else tau.clone()
    ref = tuple(x for x in gas_rayleigh_plain(base.clone(), *args)
                if x is not None)
    got = tuple(x for x in got if x is not None)
    assert len(got) == len(ref) == (1 if split else 2)
    _close(got, ref, 1e-6)
    inplace = gas_rayleigh(base, *args)
    again = _rayleigh(src, *args)
    for g, i, a in zip(got, inplace, again):
        assert torch.equal(g, i) and torch.equal(g, a)


@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_gas_minor_out_of_place_matches_twin(cuda, dims):
    """Both atmospheres' minors of both k-distributions, and the lower
    ones again with the first minor's scaling row all zeros: out of place
    (the public paths' call) within 1e-6 of the twin's largest value, tau
    untouched, bit for bit the in-place call, and bit-identical over two
    runs."""
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import _minor
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    for gas in (p.gas_lw, p.gas_sw):
        co, cg, _, h2o = _descriptors(p, gas)
        kd = gas.kdist
        tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
        nlo = len(kd.minor_lower)
        cases = []
        for lower, mset, ktab, meta in (
                (True, kd.minor_lower, kd.kminor_lower, gas.minor_meta[:nlo]),
                (False, kd.minor_upper, kd.kminor_upper,
                 gas.minor_meta[nlo:])):
            minors = tuple(m[1:] for m in gas.minors if bool(m[0]) == lower)
            sc = minor_scaling(co, mset, lower=lower, play=p.inputs.play,
                               tlay=p.inputs.tlay, col_gas=cg, idx_h2o=h2o)
            cases.append((ktab, minors, meta, sc))
            if lower:
                zero = sc.clone()
                zero[0] = 0.0
                cases.append((ktab, minors, meta, zero))
        for ktab, minors, meta, sc in cases:
            before = tau.clone()
            n0 = gas_minor.launches
            out = _minor(tau, co, ktab, minors, meta, sc)
            assert gas_minor.launches == n0 + 1
            assert torch.equal(tau, before)
            _close(out, gas_minor_plain(tau.clone(), co, ktab, minors, meta,
                                        sc), 1e-6)
            inplace = gas_minor(tau.clone(), co, ktab, minors, meta, sc)
            assert torch.equal(out, inplace)
            assert torch.equal(out, _minor(tau, co, ktab, minors, meta, sc))


# ---------------------------------------------------------------------------
# rows 7, 10 and 11 on chip: the LW no-scattering solve's three launchers,
# a column's g-points in a cluster of chunks, the layer fields in shared
# memory (ops/kernels/onchip.py); row 4 many cells per block
# ---------------------------------------------------------------------------

def _lw_pub_args(p, cuda, seed=25):
    """Row 7's inputs on the case's gas optics and sources, a seeded
    emissivity and incident flux, and the rescaled variant's ssa, g and
    per-(column, g-point) secants."""
    inp = p.inputs
    props, src = p.gas_lw.gas_optics_lw(inp.play, inp.plev, inp.tlay,
                                        inp.tsfc, inp.gas_concs,
                                        tlev=inp.tlev)
    ncol, nlay, ngpt = props.tau.shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    args = (props.tau, src.lay_source, src.lev_source,
            0.8 + 0.2 * rand(ncol, ngpt), src.sfc_source, rand(ncol, ngpt))
    rescaled = dict(ds=p.gas_lw.compute_optimal_angles(props), weight=1.0,
                    sfc_src_jac=src.sfc_source_jac,
                    ssa=0.6 * rand(ncol, nlay, ngpt),
                    g=0.9 * rand(ncol, nlay, ngpt))
    return args, rescaled


@pytest.mark.parametrize("variant", ["path", "uniform", "ragged",
                                     "rescale-jac-ds", "rescale-jac-ragged"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_lw_noscat_matches_twin(cuda, dims, variant):
    """Row 7 as the public path calls it (one scalar secant, broadband),
    by band with the k-distribution's uniform bands or three ragged,
    interleaved ones, and rescaled with the Jacobian and a secant field,
    broadband and by band (the Jacobian broadband): within chip_smoke.py's
    TOL_FLUX rule and bit-identical over two runs."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    args, rescaled = _lw_pub_args(p, cuda)
    kw = dict(ds=1.66, weight=0.5)
    if variant.startswith("rescale"):
        kw = rescaled
    if variant in ("uniform", "ragged", "rescale-jac-ragged"):
        kind = "uniform" if variant == "uniform" else "ragged"
        gpt2band, nband = _bands(args[0].shape[2], ONCHIP_CASES[dims][3],
                                 kind, cuda)
        kw = dict(kw, gpt2band=gpt2band, nband=nband)
    n0 = lw_noscat.launches
    got = tuple(x for x in lw_noscat(*args, **kw) if x is not None)
    assert lw_noscat.launches == n0 + 1
    ref = tuple(x for x in lw_noscat_plain(*args, **kw) if x is not None)
    assert len(got) == (3 if variant.startswith("rescale") else 2)
    _flux_close(got, ref)
    again = tuple(x for x in lw_noscat(*args, **kw) if x is not None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("variant", ["plain", "rescale-jac", "pfrac-clear",
                                     "pfrac-cloud"])
@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_onchip_lw_lanes_match_twins(cuda, dims, variant):
    """Rows 10 (plain, and rescaled with the Jacobian) and 11 (with and
    without the by-band cloud absorption) on the staged path's inputs, as
    permuted views and as contiguous copies: within the TOL_FLUX rule and
    bit-identical over two runs."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    inp = p.inputs
    ngpt, ncol = p.gas_lw.ngpt, inp.play.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(26)
    rand = lambda *s: torch.rand(s, generator=gen, device=cuda)
    emis = 0.8 + 0.2 * rand(ngpt, ncol)
    inc = rand(ngpt, ncol)
    if variant.startswith("pfrac"):
        cld = None
        if variant == "pfrac-cloud":
            t, ts, _ = p.cld_lw.cloud_optics_lanes(inp.lwp, inp.iwp, inp.rel,
                                                   inp.dei)
            cld = t - ts
        kernel, plain = lw_noscat_lanes_pfrac, lw_noscat_lanes_pfrac_plain
        kw = dict(ds=1.66, weight=1.0, gpt2band=p.gas_lw.gpt2band,
                  cloud_tau_abs=cld)
        cases = [c + (emis, inc) for c in _lane_cases(p, cuda)]
    else:
        tau, (sfc, lay, lev, jac) = p.gas_lw.gas_optics_lw_lanes(
            inp.play, inp.plev, inp.tlay, inp.tsfc, inp.gas_concs,
            tlev=inp.tlev)
        nlay = tau.shape[1]
        kernel, plain = lw_noscat_lanes, lw_noscat_lanes_plain
        kw = dict(ds=1.66, weight=0.7)
        if variant == "rescale-jac":
            kw.update(ssa=0.6 * rand(ngpt, nlay, ncol),
                      g=0.9 * rand(ngpt, nlay, ncol), sfc_src_jac=jac,
                      do_rescaling=True, do_jacobians=True)
        cases = [f + (emis, sfc, inc) for f in (
            (tau, lay, lev), tuple(x.contiguous() for x in (tau, lay, lev)))]
    for args in cases:
        n0 = kernel.launches
        got = tuple(x for x in kernel(*args, **kw) if x is not None)
        assert kernel.launches == n0 + 1
        _flux_close(got, tuple(x for x in plain(*args, **kw)
                               if x is not None))
        again = tuple(x for x in kernel(*args, **kw) if x is not None)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("variant", ["path", "byband", "rescale-jac",
                                     "lanes-rescale-jac", "pfrac"])
def test_onchip_lw_noscat_tallest_column_and_past_it(cuda, variant):
    """The tallest column that the narrowest chunk (32 g-points) holds at
    the flagship's 256 g-points, for each launcher and variant, on seeded
    inputs (optical depths from 1e-6 to 10) against the twin; one layer
    more raises ValueError naming the limit and launches nothing."""
    ngpt, nband, ncol = 256, 16, 3
    rng = np.random.default_rng(27)
    u = lambda lo, hi, *s: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    gpt2band = torch.arange(ngpt, device=cuda, dtype=torch.int32) // 16
    v = dict(rescale="rescale" in variant, jacobian="jac" in variant,
             pfrac=variant == "pfrac")
    with pytest.raises(ValueError, match="at most") as e:
        onchip_geometry("solver_lw", 10 ** 6, ngpt,
                        nband if variant == "byband" else 0, **v)
    nlay = int(str(e.value).split("at most ")[1].split()[0])

    def call(n, wrapper):
        lay3 = (ncol, n, ngpt)
        tau = torch.from_numpy((10.0 ** rng.uniform(-6.0, 1.0, lay3))
                               .astype(np.float32)).to(cuda)
        lay, lev = u(0.5, 1.5, *lay3), u(0.5, 1.5, ncol, n + 1, ngpt)
        emis, sfc, inc = (u(0.8, 1.0, ncol, ngpt), u(0.5, 1.5, ncol, ngpt),
                          u(0.0, 0.5, ncol, ngpt))
        t3 = lambda x: x.permute(2, 1, 0)
        if variant == "pfrac":
            f = lw_noscat_lanes_pfrac if wrapper else \
                lw_noscat_lanes_pfrac_plain
            return f(t3(tau), t3(u(0.0, 1.0, *lay3)),
                     u(0.5, 1.5, 16, n, ncol), u(0.5, 1.5, 16, n + 1, ncol),
                     u(0.5, 1.5, 16, ncol), emis.T, inc.T, ds=1.66,
                     weight=0.5, gpt2band=gpt2band,
                     cloud_tau_abs=u(0.0, 0.5, 16, n, ncol))
        if variant == "lanes-rescale-jac":
            f = lw_noscat_lanes if wrapper else lw_noscat_lanes_plain
            return f(t3(tau), t3(lay), t3(lev), emis.T, sfc.T, inc.T,
                     ds=1.66, weight=0.5, ssa=t3(u(0.0, 0.6, *lay3)),
                     g=t3(u(0.0, 0.9, *lay3)),
                     sfc_src_jac=u(0.0, 0.1, ncol, ngpt).T,
                     do_rescaling=True, do_jacobians=True)
        kw = dict(ds=1.66, weight=0.5)
        if variant == "byband":
            kw.update(gpt2band=gpt2band, nband=nband)
        if variant == "rescale-jac":
            kw.update(ds=u(1.0, 2.0, ncol, ngpt),
                      sfc_src_jac=u(0.0, 0.1, ncol, ngpt),
                      ssa=u(0.0, 0.6, *lay3), g=u(0.0, 0.9, *lay3))
        f = lw_noscat if wrapper else lw_noscat_plain
        return f(tau, lay, lev, emis, sfc, inc, **kw)

    kernel = {"pfrac": lw_noscat_lanes_pfrac,
              "lanes-rescale-jac": lw_noscat_lanes}.get(variant, lw_noscat)
    state = rng.bit_generator.state
    n0 = kernel.launches
    got = tuple(x for x in call(nlay, True) if x is not None)
    assert kernel.launches == n0 + 1
    rng.bit_generator.state = state
    _flux_close(got, tuple(x for x in call(nlay, False) if x is not None))
    with pytest.raises(ValueError, match=f"at most {nlay} layers"):
        call(nlay + 1, True)
    assert kernel.launches == n0 + 1


@pytest.mark.parametrize("dims", sorted(ONCHIP_CASES))
def test_gas_major_many_cells_matches_twin(cuda, dims):
    """Row 4 at the paths' widths (LW with the Planck fraction from the
    interleaved table, SW without), on cells of both atmospheres: within
    1e-6 of the twin's largest value and bit-identical over two runs;
    without the interleaved table an LW call raises and launches
    nothing."""
    p = build_allsky(*ONCHIP_CASES[dims], device=cuda)
    for gas in (p.gas_lw, p.gas_sw):
        co = _descriptors(p, gas)[0]
        assert bool(co.tropo.any()) and not bool(co.tropo.all())
        kd = gas.kdist
        args = (co, kd.kmajor, kd.planck_frac, gas.gpoint_flavor)
        n0 = gas_major.launches
        got = tuple(x for x in gas_major(*args, gas.kmajor_pfrac)
                    if x is not None)
        assert gas_major.launches == n0 + 1
        assert len(got) == (2 if kd.planck_frac is not None else 1)
        _close(got, tuple(x for x in gas_major_plain(*args)
                          if x is not None), 1e-6)
        again = tuple(x for x in gas_major(*args, gas.kmajor_pfrac)
                      if x is not None)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if kd.planck_frac is not None:
            with pytest.raises(ValueError, match="kmajor_pfrac is missing"):
                gas_major(*args)
            assert gas_major.launches == n0 + 2


def test_kernels_match_frozen_digests(cuda):
    """Rows 2 (the fused LW step, broadband, by band, with an incident
    flux and without clouds) and 5 (the minor gather), both rewritten,
    and rows 3 (the fused SW step) and 16 (the fused LW adjoint), which
    share csrc/common.cuh and transport.cuh with them; and rows 4 (the
    major gather, LW and SW), 7 (the LW no-scattering solve as the public
    path calls it, by band, rescaled with the Jacobian and a secant
    field), 10 (plain and rescaled with the Jacobian) and 6 (the Rayleigh
    gather, with ssa and split: 0 + Rayleigh), rewritten later, give bit
    for bit the outputs recorded from them before each was rewritten, in
    place and out of place as the gas optics call the gathers; rows 11
    (with and without cloud) and 14 (the LW no-scattering solve's
    adjoint) those of their rewritten kernels, whose arithmetic nvcc
    compiles to other bits than the one-block kernels'
    (tests/golden/kernel_digests_frozen.json:
    kernel_digest_record.record, written by
    scripts/freeze_kernel_digests.py). The bits are those of one CUDA
    compiler and runtime: after a change of either, the record is written
    again on the card from a checkout whose kernels are known good."""
    import json
    import os
    from kernel_digest_record import record
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tests", "golden",
                           "kernel_digests_frozen.json")) as f:
        rec = json.load(f)
    got = record(cuda)
    assert len(rec) == 2 * 24
    assert got == rec
    out = record(cuda, out_of_place=True)
    assert out == rec


# ---- the RFMIP driver, SSM and the pod-scale stream: the kernels at the
# shapes these paths give them ----

RFMIP_FLAGSHIP = (256, 16, 224, 14, 14, 59)


def _rfmip(cuda, nsite=8, nlay=61, nexp=3, seed=5):
    """An RFMIP problem (61 layers: not a multiple of the ring sweeps' 4)
    with a per-column TSI from a fixed seed and night columns, and the
    flagship LW and SW providers, on the card."""
    import dataclasses
    from rte_rrtmgp_tpu_torch.drivers.rfmip import synthetic_rfmip
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist
    data = synthetic_rfmip(nsite, nlay, nexp)
    rng = np.random.default_rng(seed)
    data = dataclasses.replace(data, tsi=rng.uniform(
        1300.0, 1420.0, data.ncol).astype(np.float32))
    ngl, nbl, ngs, nbs, ntemp, npres = RFMIP_FLAGSHIP
    kw = dict(ntemp=ntemp, npres=npres, device=cuda)
    return (data, GasOpticsRRTMGP(synthetic_kdist(sw=False, ngpt=ngl,
                                                  nbnd=nbl, **kw)),
            GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=ngs, nbnd=nbs,
                                            **kw)))


def test_rfmip_fused_kernels_match_twins(cuda):
    """Rows 2 and 3 at 61 layers on the RFMIP driver's inputs: the fused
    SW kernel with the TSI-scaled direct incident flux and mu0 = 1 on the
    night columns."""
    from rte_rrtmgp_tpu_torch.drivers import rfmip
    data, g_lw, g_sw = _rfmip(cuda)
    x = rfmip._inputs(data, g_lw)
    args, kw = rfmip._lw_fused_args(g_lw, True, *rfmip._lw_args(x))
    lw = g_lw.lw_fused_inputs(*args, **kw)
    n0 = lw_fused.launches
    _flux_close(lw_fused(lw), lw_fused_plain(lw))
    assert lw_fused.launches == n0 + 1
    usecol, mu0 = rfmip._sun(x["sza"])
    assert bool((~usecol).any()) and bool(usecol.any())
    args, kw = rfmip._sw_fused_args(g_sw, True, x["play"], x["plev"],
                                    x["tlay"], x["sfc_alb"], x["tsi"], mu0,
                                    x["gas_concs"])
    sw = g_sw.sw_fused_inputs(*args, **kw)
    assert float(sw.inc.std(dim=1).max()) > 0   # the TSI varies by column
    n0 = sw_fused.launches
    _flux_close(sw_fused(sw), sw_fused_plain(sw))
    assert sw_fused.launches == n0 + 1


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_ssm_solvers_match_twins(cuda, band):
    """Rows 7 and 9 at SSM's 41 g-points in 41 bands (a chunk of 32 and a
    ragged one of 9) on RFMIP's 61 layers, as rte_lw and rte_sw call them
    on the RFMIP driver's generic route."""
    from rte_rrtmgp_tpu_torch.drivers import rfmip
    from rte_rrtmgp_tpu_torch.models.ssm import (ssm_lw_defaults,
                                                 ssm_sw_defaults)
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS
    data = _rfmip(cuda)[0]
    if band == "lw":
        ssm = ssm_lw_defaults(device=cuda)
        x = rfmip._inputs(data, ssm)
        props, src = ssm.gas_optics_lw(x["play"], x["plev"], x["tlay"],
                                       x["sfc_t"], x["gas_concs"],
                                       tlev=x["tlev"], top_at_1=True)
        emis = x["sfc_emis"][:, None].expand(-1, 41).contiguous()
        args = (props.tau, src.lay_source, src.lev_source, emis,
                src.sfc_source, torch.zeros_like(emis))
        kw = dict(ds=float(GAUSS_DS[0][0]), weight=float(GAUSS_WTS[0][0]))
        n0 = lw_noscat.launches
        fluxes = lambda f: tuple(v for v in f(*args, **kw) if v is not None)
        _flux_close(fluxes(lw_noscat), fluxes(lw_noscat_plain))
        assert lw_noscat.launches == n0 + 1
    else:
        ssm = ssm_sw_defaults(device=cuda)
        x = rfmip._inputs(data, ssm)
        props, toa = ssm.gas_optics_sw(x["play"], x["plev"], x["tlay"],
                                       x["gas_concs"], top_at_1=True)
        _, mu0 = rfmip._sun(x["sza"])
        alb = x["sfc_alb"][:, None].expand(-1, 41).contiguous()
        args = (props.tau, props.ssa, props.g,
                mu0[:, None].expand(-1, props.tau.shape[1]).contiguous(),
                alb, alb, (toa * (x["tsi"] / toa.sum(-1))[:, None])
                .contiguous())
        n0 = sw_2stream.launches
        _flux_close(sw_2stream(*args), sw_2stream_plain(*args))
        assert sw_2stream.launches == n0 + 1


def test_rfmip_blocked_equals_unblocked_on_card(cuda):
    """rfmip_lw_sw's block loop against one launch, within
    tests/test_rfmip.py's bounds; fused_lw and fused_sw once per block."""
    from rte_rrtmgp_tpu_torch.drivers.rfmip import rfmip_lw_sw
    data, g_lw, g_sw = _rfmip(cuda)
    whole = rfmip_lw_sw(data, g_lw, g_sw)
    n0 = (lw_fused.launches, sw_fused.launches)
    blk = rfmip_lw_sw(data, g_lw, g_sw, block_size=data.nsite)
    assert (lw_fused.launches - n0[0], sw_fused.launches - n0[1]) == \
        (data.nexp, data.nexp)
    for a, b in zip(blk, whole):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-5)
    dev = rfmip_lw_sw(data, g_lw, g_sw, device_out=True)
    assert dev.device.type == "cuda"
    np.testing.assert_array_equal(dev.cpu().numpy(), np.stack(whole))


@pytest.mark.parametrize("route", ["fused", "generic", "ssm"])
def test_rfmip_routes_on_card(cuda, route):
    """rfmip_lw_sw at 1800 x 61 (100 sites x 18 experiments, a per-column
    TSI, night columns). The fused route: fused_lw and fused_sw once, the
    scaling rows and the descriptors once per gas-optics call, nothing
    else; the device result the host readback's; finite, non-negative
    fluxes, the night columns' SW zero, TOA SW down TSI mu0 on the day
    columns (rel 1e-5). The generic route (the gathers and the public
    solvers, as ``fused_ok=False`` runs them): its launches, and its
    fluxes within rtol 3e-5 / atol 5e-4 W/m2 of the fused route's. SSM:
    solver_lw and solver_sw once, finite fluxes."""
    from rte_rrtmgp_tpu_torch.drivers import rfmip
    from rte_rrtmgp_tpu_torch.models.ssm import (ssm_lw_defaults,
                                                 ssm_sw_defaults)
    data, g_lw, g_sw = _rfmip(cuda, nsite=100, nexp=18)
    if route == "ssm":
        s_lw, s_sw = ssm_lw_defaults(device=cuda), ssm_sw_defaults(device=cuda)
        out, got = _launches(lambda: rfmip.rfmip_lw_sw(data, s_lw, s_sw,
                                                       device_out=True))
        _assert_launches(got, dict(solver_lw=1, solver_sw=1))
        assert bool(torch.isfinite(out).all())
        return
    host, got = _launches(lambda: rfmip.rfmip_lw_sw(data, g_lw, g_sw))
    _assert_launches(got, dict(fused_lw=1, fused_sw=1, minor_scale=2,
                               gas_descriptors=2))
    out = rfmip.rfmip_lw_sw(data, g_lw, g_sw, device_out=True)
    np.testing.assert_array_equal(out.cpu().numpy(), np.stack(host))
    assert bool(torch.isfinite(out).all()) and not bool((out < 0).any())
    x = rfmip._inputs(data, g_lw)
    usecol, mu0 = rfmip._sun(x["sza"])
    assert bool((~usecol).any()) and not bool((out[2:, ~usecol] != 0).any())
    toa = (x["tsi"] * mu0)[usecol].double()
    assert float(((out[3, usecol, 0].double() - toa).abs() / toa).max()) \
        <= 1e-5
    if route == "generic":
        lw = rfmip._lw_compute(g_lw, True, False, 1)
        sw = rfmip._sw_compute(g_sw, True, False)
        gen, got = _launches(
            lambda: lw(*rfmip._lw_args(x)) + sw(*rfmip._sw_args(x)))
        _assert_launches(got, dict(gas_major=2, gas_minor=4, gas_rayleigh=1,
                                   solver_lw=1, solver_sw=1, minor_scale=2,
                                   gas_descriptors=2))
        _paths_agree(gen, tuple(out))


# chunk columns, layers, k-distribution and chunks streamed: at 32
# g-points, and at the flagship widths in chunks of 4096 x 72
PODSCALE_CASES = {"g32": ((64, 9, 32, 4, 32, 4, 5, 10), 7),
                  "main": (MAIN, 4)}


@pytest.mark.parametrize("case", sorted(PODSCALE_CASES))
def test_podscale_streamed_equals_resident(cuda, case):
    """The pod-scale loop over a few chunks, streamed (a pinned pool of 3
    distinct chunks, copy stream, two device buffers in turn) and
    resident: each streamed chunk's outputs bit for bit the fused step's
    on its pool entry, the pool entries' outputs distinct, the last
    chunk's the resident run's; cloud_props twice, fused_lw and fused_sw
    once, the scaling rows and the descriptors twice per chunk."""
    from rte_rrtmgp_tpu_torch.parallel.scaling import _podscale, _pool_entry
    shape, n = PODSCALE_CASES[case]
    chunk, nlay = shape[:2]
    dims = dict(zip(("ngpt_lw", "nbnd_lw", "ngpt_sw", "nbnd_sw", "ntemp",
                     "npres"), shape[2:]), chunk_cols_per_device=chunk,
                reps_per_chunk=1, host_pool=3, verbose=False, device=cuda)
    # chunk k reads pool entry k % 3 from buffer k % 2; the last, entry 0
    (r, streamed), got = _launches(
        lambda: _podscale(n * chunk, nlay, stream=True, keep=True, **dims))
    assert r["n_chunks"] == n and len(streamed) == n
    assert (len(streamed) - 1) % 3 == 0
    # the untimed first step and one step per chunk
    _assert_launches(got, dict(cloud_props=2 * (n + 1), fused_lw=n + 1,
                               fused_sw=n + 1, minor_scale=2 * (n + 1),
                               gas_descriptors=2 * (n + 1)))
    _, resident = _podscale(3 * chunk, nlay, stream=False, **dims)
    step, inputs = build_allsky_step(*shape, device=cuda)
    refs = []
    for j in range(3):
        lw_up, _, sw_up, _, _ = step(_pool_entry(inputs, j))
        refs.append((lw_up[:, 0], sw_up[:, 0]))
    assert not any(torch.equal(a, b) for j in (1, 2)
                   for a, b in zip(refs[0], refs[j]))
    for k, out in enumerate(streamed):
        for a, ref in zip(out, refs[k % 3]):
            assert bool(torch.isfinite(a).all())
            assert torch.equal(a, ref)
    for a, b in zip(streamed[-1], resident[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("late", ["step", "upload"])
def test_podscale_uploads_keep_their_order(cuda, monkeypatch, late):
    """The streamed loop's event order, with steps that make no host wait
    (the all-sky step's host waits keep the card from falling behind):
    each step spins the card, then reads its chunk's tlay and tlev; with
    ``late="step"`` the card runs chunks behind the host, so an upload
    that did not wait for the step last reading its buffer overwrites
    that step's inputs; with ``late="upload"`` each upload spins the copy
    stream first, so a step that did not wait for its upload reads the
    buffer's previous chunk. Each chunk reads pool entry k % 3."""
    from types import SimpleNamespace
    from rte_rrtmgp_tpu_torch.parallel import scaling
    spin = 10_000_000                          # cycles: about 5 ms
    if late == "step":
        def read(field):
            def step(inputs, *args, **kw):
                torch.cuda._sleep(spin)
                return SimpleNamespace(flux_up=getattr(inputs, field) * 1.0)
            return step
        monkeypatch.setattr(scaling, "allsky_step_lw", read("tlay"))
        monkeypatch.setattr(scaling, "allsky_step_sw", read("tlev"))
    else:
        for name, field in (("allsky_step_lw", "tlay"),
                            ("allsky_step_sw", "tlev")):
            monkeypatch.setattr(scaling, name,
                                lambda i, *a, f=field, **k: SimpleNamespace(
                                    flux_up=getattr(i, f) * 1.0))
        put = scaling._Uploads.put

        def slow_put(self, *args):
            with torch.cuda.stream(self.copy):
                torch.cuda._sleep(spin)
            put(self, *args)

        monkeypatch.setattr(scaling._Uploads, "put", slow_put)
    n = 9
    _, outs = scaling._podscale(
        n * 64, 9, stream=True, keep=True, chunk_cols_per_device=64,
        ngpt_lw=32, nbnd_lw=4, ngpt_sw=32, nbnd_sw=4, ntemp=5, npres=10,
        reps_per_chunk=1, host_pool=3, verbose=False, device=cuda)
    _, inputs = build_allsky_step(64, 9, 32, 4, 32, 4, 5, 10, device=cuda)
    refs = [(e.tlay[:, 0], e.tlev[:, 0])
            for e in (scaling._pool_entry(inputs, j) for j in range(3))]
    wrong = [k for k, out in enumerate(outs)
             if not all(map(torch.equal, out, refs[k % 3]))]
    assert len(outs) == n and wrong == []


def _host(x):
    """All-sky inputs with every tensor in host memory."""
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    cpu = lambda t: None if t is None else t.cpu()
    gas = x.gas_concs
    return x._replace(
        gas_concs=GasConcs(names=gas.names,
                           values=tuple(cpu(v) for v in gas.values)),
        **{f: cpu(getattr(x, f)) for f in x._fields if f != "gas_concs"})


def test_stream_whole_grid_equals_resident_chunks(cuda):
    """ne30pg2 (21,600 columns: 5 chunks of 4096 and one of 1,120) at 72
    layers and the flagship widths, sun uniform on [-1, 1]: three sweeps
    over two grids (value checks on, then off); each sweep's LW bit for
    bit allsky_step_lw on each chunk resident on the card, its SW bit for
    bit allsky_step_sw on each chunk's day columns gathered on the card,
    exactly 0 on the night columns; 6 chunks, the day columns and the
    bytes counted; fused_lw and fused_sw once per chunk."""
    import contextlib

    from rte_rrtmgp_tpu_torch import trace
    from rte_rrtmgp_tpu_torch.config import checks_disabled
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_tpu_torch.parallel.scaling import (
        STEP_FIELDS, AllSkyStream, _columns, _pool_entry)
    ncol, chunk = 21_600, 4096
    p = build_allsky(ncol, 72, 256, 16, 224, 14, 14, 59, device=cuda)
    g = torch.Generator().manual_seed(11)
    grids = [_pool_entry(p.inputs, j)._replace(
        mu0=(torch.rand(ncol, generator=g) * 2 - 1).to(cuda))
        for j in range(2)]
    stream = AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw,
                          chunk=chunk, device=cuda)
    hosts = [stream.pin(_host(x)) for x in grids]
    for sweep, j in enumerate((0, 1, 0)):
        n0 = (lw_fused.launches, sw_fused.launches)
        checks = checks_disabled() if sweep else contextlib.nullcontext()
        with checks, trace.collect() as rec:
            out = [f.clone() for f in stream.run(hosts[j])]
        c = rec.counters
        mu0 = hosts[j].mu0
        assert c["stream.chunks"] == 6
        assert c["stream.sw_columns"] == int((mu0 > 0).sum())
        assert c["stream.bytes_down"] == 5 * ncol * 73 * 4
        assert (lw_fused.launches - n0[0], sw_fused.launches - n0[1]) == \
            (6, 6)
        grid = grids[j]
        for c0 in range(0, ncol, chunk):
            c1 = min(c0 + chunk, ncol)
            x = _columns(grid, c0, c1)
            lw = allsky_step_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
            assert torch.equal(out[0][c0:c1], lw.flux_up.cpu())
            assert torch.equal(out[1][c0:c1], lw.flux_dn.cpu())
            day = torch.nonzero(mu0[c0:c1] > 0).flatten()
            i = day.to(cuda)
            gas = x.gas_concs
            sub = x._replace(
                gas_concs=GasConcs(names=gas.names, values=tuple(
                    v[i] if v.ndim == 2 else v for v in gas.values)),
                **{f: getattr(x, f)[i] for f in STEP_FIELDS})
            sw = allsky_step_sw(sub, p.gas_sw, cloud_optics=p.cld_sw)
            night = mu0[c0:c1] <= 0
            for o, f in zip(out[2:], (sw.flux_up, sw.flux_dn,
                                      sw.flux_dn_dir)):
                assert torch.equal(o[c0:c1][day], f.cpu())
                assert bool((o[c0:c1][night] == 0).all())
    torch.cuda.synchronize()


def test_stream_readback_waits_for_each_chunk(cuda, monkeypatch):
    """The stream's event order with steps that make no host wait: each
    step spins the card (about 5 ms), then returns fluxes read from its
    chunk's inputs; the host runs chunks ahead of the card, so a readback
    that did not wait for its chunk's step, or an upload that did not
    wait for the step last reading its buffer, puts other values in the
    host buffers. 9 chunks of 64 and one of 17, half night."""
    from types import SimpleNamespace
    from rte_rrtmgp_tpu_torch.parallel import scaling
    spin = 10_000_000

    def step(x, *a, **k):
        torch.cuda._sleep(spin)
        return SimpleNamespace(flux_up=x.plev * 1.0, flux_dn=x.plev * 2.0,
                               flux_dn_dir=x.plev * 3.0)

    monkeypatch.setattr(scaling, "allsky_step_lw", step)
    monkeypatch.setattr(scaling, "allsky_step_sw", step)
    ncol = 9 * 64 + 17
    p = build_allsky(ncol, 9, 32, 4, 32, 4, 5, 10, device=cuda)
    g = torch.Generator().manual_seed(5)
    grid = _host(p.inputs)._replace(
        plev=torch.rand(ncol, 10, generator=g) * 1e5,
        mu0=torch.rand(ncol, generator=g) * 2 - 1)
    stream = scaling.AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw,
                                  chunk=64, device=cuda)
    out = stream.run(stream.pin(grid))
    day = (grid.mu0 > 0)[:, None]
    for o, k, lit in zip(out, (1.0, 2.0, 1.0, 2.0, 3.0),
                         (False, False, True, True, True)):
        want = grid.plev * k
        assert torch.equal(o, torch.where(day, want, 0.0) if lit else want)


def _aerosol_case(cuda, nbnd, ncol=4096, nlay=72, seed=9):
    """MERRA tables on ``nbnd`` bands with an RH grid from 0.1 to 0.99,
    float32 on the card, and (ncol, nlay) cells: type codes 0-8 (8
    unknown), sizes across the five bins and on their edges, RH below the
    grid, on its points, between them and at 1.0 in turn by column."""
    from rte_rrtmgp_tpu_torch.models.rrtmgp.aerosol_optics import (
        AerosolOpticsMERRA)
    from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_aerosol_raw
    raw = synthetic_aerosol_raw(nbnd=nbnd, seed=seed)
    grid = np.linspace(0.1, 0.99, 37)
    raw["aero_rh"] = grid
    aer = AerosolOpticsMERRA.load(dtype=torch.float32, device=cuda, **raw)
    g = np.random.default_rng(seed)
    edges = np.logspace(-1, 1, 6)
    size = g.uniform(edges[0], edges[-1], (ncol, nlay))
    size[:, :6] = edges
    k = g.integers(0, len(grid) - 1, (ncol, nlay))
    rh = np.stack([g.uniform(0.0, grid[0], (ncol, nlay)), grid[k],
                   grid[k] + 0.5 * (grid[k + 1] - grid[k]),
                   np.ones((ncol, nlay))])[np.arange(ncol) % 4,
                                           np.arange(ncol)]
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=cuda)
    x = (t(g.integers(0, 9, (ncol, nlay)), torch.int32), t(size),
         t(g.uniform(1e-7, 1e-4, (ncol, nlay))), t(rh))
    return aer, x


@pytest.mark.parametrize("clouds", [False, True], ids=["clear", "cloudy"])
@pytest.mark.parametrize("mode", ["lanes", "lw", "sw"])
def test_aerosol_props_matches_twin(cuda, mode, clouds):
    """The aerosol lookup kernel at 4096 x 72 (LW 16 bands, SW 14) in
    each mode (the lanes; the LW increment, the absorption plus the
    clouds'; the SW increment, delta-scaled and combined with the
    clouds'), with and without clouds: one launch; within 2e-6 of the
    largest value of its float32 twin on the same inputs and within 1e-5
    of the float64 twin's (every type code, both size-binned species,
    RH below, on and between the grid's points and at 1.0, type 0 and
    an unknown code); the same bits twice."""
    from rte_rrtmgp_tpu_torch.ops.kernels import aerosol_props as ap
    nbnd = 14 if mode == "sw" else 16
    aer, x = _aerosol_case(cuda, nbnd)
    ncol, nlay = x[0].shape
    cloud = None
    if clouds:
        gen = torch.Generator(device=cuda).manual_seed(3)
        u = lambda: torch.rand((nbnd, nlay, ncol), generator=gen,
                               device=cuda)
        t = 3.0 * u() * (u() > 0.33)
        ts = t * (0.4 + 0.6 * u())
        cloud = (t, ts, ts * (0.6 + 0.35 * u()))
    m = dict(lanes=ap.LANES, lw=ap.LW, sw=ap.SW)[mode]
    args = (*x, aer.lut, aer.offsets, cloud, m)
    n0 = aerosol_props.launches
    got = aerosol_props(*args)
    assert aerosol_props.launches == n0 + 1
    assert torch.equal(got, aerosol_props(*args))
    _close(got, aerosol_props_plain(*args), 2e-6)
    d = lambda v: v.double() if v.is_floating_point() else v
    ref = aerosol_props_plain(*(d(v) for v in x),
                              tuple(d(v) for v in aer.lut), aer.offsets,
                              None if cloud is None
                              else tuple(d(v) for v in cloud), m)
    assert float((got.double() - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())
    assert bool((got[0] != 0).any())


def test_stream_aerosols_equals_resident_chunks(cuda):
    """ne30pg2 (21,600 x 72, chunks of 4096 and one of 1,120) at the
    flagship widths with the all-sky example's aerosols, the stream given
    the LW and SW aerosol optics: two sweeps over two grids (value checks
    on, then off); each sweep's LW bit for bit allsky_step_lw with
    aerosols on each chunk resident on the card, its SW bit for bit
    allsky_step_sw with aerosols on each chunk's day columns, 0 at night;
    the bytes up count the aerosol fields; the aerosol lookup once per
    gas-optics call (at most 2 a chunk); with the checks off the sweep
    makes one host wait (its readback) and torch's sync debug mode sees
    at most that one."""
    import contextlib
    import warnings

    from rte_rrtmgp_tpu_torch import trace
    from rte_rrtmgp_tpu_torch.config import checks_disabled
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    from rte_rrtmgp_tpu_torch.parallel.scaling import (
        AEROSOL_FIELDS, STEP_FIELDS, AllSkyStream, _columns, _pool_entry)
    ncol, chunk = 21_600, 4096
    p = build_allsky(ncol, 72, 256, 16, 224, 14, 14, 59, device=cuda,
                     use_aerosols=True)
    g = torch.Generator().manual_seed(12)
    grids = [_pool_entry(p.inputs, j)._replace(
        mu0=(torch.rand(ncol, generator=g) * 2 - 1).to(cuda))
        for j in range(2)]
    stream = AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw,
                          chunk=chunk, device=cuda, aerosol_lw=p.aer_lw,
                          aerosol_sw=p.aer_sw)
    hosts = [stream.pin(_host(x)) for x in grids]
    fields = STEP_FIELDS + AEROSOL_FIELDS
    aer = dict(use_aerosols=True)
    for sweep, j in enumerate((0, 1)):
        n0 = aerosol_props.launches
        checks = checks_disabled() if sweep else contextlib.nullcontext()
        with checks, trace.collect() as rec:
            out = [f.clone() for f in stream.run(hosts[j])]
        c = rec.counters
        mu0 = hosts[j].mu0
        sw_chunks = sum(bool((mu0[c0:c0 + chunk] > 0).any())
                        for c0 in range(0, ncol, chunk))
        assert aerosol_props.launches - n0 == 6 + sw_chunks <= 2 * 6
        assert c["launches.aerosol_props"] == 6 + sw_chunks
        aer_bytes = sum(getattr(hosts[j], f).numel() * 4
                        for f in AEROSOL_FIELDS)
        assert aer_bytes == 4 * 4 * ncol * 72
        if sweep:
            assert c["waits"] == 1
        grid = grids[j]
        for c0 in range(0, ncol, chunk):
            c1 = min(c0 + chunk, ncol)
            x = _columns(grid, c0, c1, fields)
            lw = allsky_step_lw(x, p.gas_lw, cloud_optics=p.cld_lw,
                                aerosol_optics=p.aer_lw, **aer)
            assert torch.equal(out[0][c0:c1], lw.flux_up.cpu())
            assert torch.equal(out[1][c0:c1], lw.flux_dn.cpu())
            day = torch.nonzero(mu0[c0:c1] > 0).flatten()
            i = day.to(cuda)
            gas = x.gas_concs
            sub = x._replace(
                gas_concs=GasConcs(names=gas.names, values=tuple(
                    v[i] if v.ndim == 2 else v for v in gas.values)),
                **{f: getattr(x, f)[i] for f in fields})
            sw = allsky_step_sw(sub, p.gas_sw, cloud_optics=p.cld_sw,
                                aerosol_optics=p.aer_sw, **aer)
            night = mu0[c0:c1] <= 0
            for o, f in zip(out[2:], (sw.flux_up, sw.flux_dn,
                                      sw.flux_dn_dir)):
                assert torch.equal(o[c0:c1][day], f.cpu())
                assert bool((o[c0:c1][night] == 0).all())
    # the bytes up: the stream without aerosols' and the aerosol fields
    plain = AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw,
                         chunk=chunk, device=cuda)
    with checks_disabled():
        with trace.collect() as bare:
            plain.run(hosts[0])
        with trace.collect() as rec:
            stream.run(hosts[0])
    assert rec.counters["stream.bytes_up"] == \
        bare.counters["stream.bytes_up"] + 4 * 4 * ncol * 72
    assert bare.counters.get("launches.aerosol_props", 0) == 0
    # one host wait a sweep, under torch's sync debug mode
    seen = []
    with checks_disabled(), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda m, *a, **k: seen.append(str(m))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stream.run(hosts[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert sum("synchroniz" in m for m in seen) <= 1, seen
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the paths on the card: float32 against float64 at the production
# configuration, the surface Jacobian, and each path's launches and
# agreement with the fused step at the main shapes
# ---------------------------------------------------------------------------

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the production configuration of tests/golden/production.npz: 256 x 72 at
# the flagship widths
PROD = (256,) + MAIN[1:]
FLUXES = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")
# one path against another on the same inputs (the JAX package's bound
# for its fused-vs-generic test, tests/test_pallas_gas_optics.py:275)
PATH_RTOL, PATH_ATOL = 3e-5, 5e-4


def _paths_agree(out, ref):
    """Each flux within PATH_RTOL of the reference's plus PATH_ATOL W/m2."""
    gap = max(float(((a - f).abs() - PATH_RTOL * f.abs()).max())
              for a, f in zip(out, ref))
    assert gap <= PATH_ATOL, gap


@pytest.mark.parametrize("path", ["fused", "api", "staged", "aerosols",
                                  "two-stream", "rfmip"])
def test_float32_paths_match_float64_on_card(cuda, path):
    """The float32 paths on the card against float64 (the golden rule):
    the fused step, the public API and the staged branch at the
    production configuration against tests/golden/production.npz; the
    aerosols fused step and the LW two-stream path there against the
    port's float64 twin of the same path on the CPU (no golden is
    committed for either); each field within 3x its float32 noise floor
    (tests/golden/production_f32_noise.json). The RFMIP driver at the
    golden's shape (6 sites x 20 layers x 3 experiments, 32 g-points)
    against tests/golden/rfmip.npz, each field within 3x the distance of
    the port's float32 twin of the same driver on the CPU."""
    if path == "rfmip":
        from rte_rrtmgp_tpu_torch.drivers.rfmip import rfmip_lw, rfmip_sw
        from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (
            GasOpticsRRTMGP)
        from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist

        def run(device):
            data = synthetic_rfmip(6, 20, 3)
            kd = dict(ngpt=32, nbnd=4, ntemp=6, npres=12, device=device)
            out = (rfmip_lw(data, GasOpticsRRTMGP(synthetic_kdist(
                sw=False, **kd))) + rfmip_sw(data, GasOpticsRRTMGP(
                    synthetic_kdist(sw=True, **kd))))
            return dict(zip(FLUXES, out))
        card, twin = run(cuda), run("cpu")
        golden = np.load(os.path.join(GOLDEN, "rfmip.npz"))
        for key in golden.files:
            d = float(np.abs(card[key] - golden[key]).max())
            t = float(np.abs(twin[key] - golden[key]).max())
            assert d <= 3 * t, (key, d, t)
        return
    if path in ("aerosols", "two-stream"):
        opts = dict(use_aerosols=path == "aerosols")
        p = build_allsky(*PROD, device=cuda, **opts)
        p64 = build_allsky(*PROD, device="cpu", dtype=torch.float64, **opts)
        route, kw = (path, {}) if path == "two-stream" else ("step", opts)
        golden = dict(zip(FLUXES, (x.numpy() for x in _composed_step(
            p64, route, **kw)(p64.inputs))))
        out = _composed_step(p, route, **kw)(p.inputs)
    else:
        golden = np.load(os.path.join(GOLDEN, "production.npz"))
        p = build_allsky(*PROD, device=cuda)
        out = _composed_step(p, "step" if path == "fused" else path)(p.inputs)
    with open(os.path.join(GOLDEN, "production_f32_noise.json")) as f:
        noise = json.load(f)["f32_noise"]
    for key, o in zip(FLUXES, out):
        d = float(np.abs(o.double().cpu().numpy() - golden[key]).max())
        assert d <= 3 * noise[key], (key, d, 3 * noise[key])


def test_fused_tsfc_gradient_matches_surface_jacobian(cuda):
    """d(sum of TOA LW up)/d(tsfc) through the fused step on the card, at
    the production configuration, against the analytic surface Jacobian
    that lw_solver_noscat transports: all positive, within a relative 2e-2
    (tests/test_fused_autodiff.py:110-149)."""
    from rte_rrtmgp_tpu_torch.ops.solver_lw import (GAUSS_DS, GAUSS_WTS,
                                                    lw_solver_noscat)
    p = build_allsky(*PROD, device=cuda)
    i = p.inputs
    tsfc = i.tsfc.clone().requires_grad_()
    f = allsky_step_lw(i._replace(tsfc=tsfc), p.gas_lw, cloud_optics=p.cld_lw)
    grad, = torch.autograd.grad(f.flux_up[:, 0].sum(), tsfc)
    props, src = p.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                        i.gas_concs, tlev=i.tlev,
                                        top_at_1=True)
    props = increment(props, p.cld_lw.cloud_optics(i.lwp, i.iwp, i.rel,
                                                   i.dei, scattering=False))
    emis = i.sfc_emis.expand(-1, props.tau.shape[2]).contiguous()
    jac = lw_solver_noscat(props.tau, src.lay_source, src.lev_source, emis,
                           src.sfc_source, torch.zeros_like(emis),
                           top_at_1=True, ds=GAUSS_DS[0],
                           weights=GAUSS_WTS[0],
                           sfc_src_jac=src.sfc_source_jac,
                           do_jacobians=True).flux_up_jac[:, 0]
    assert bool((jac > 0).all())
    assert float(((grad - jac).abs() / jac.abs()).max()) <= 2e-2


@pytest.fixture(scope="module")
def flagship():
    """The paths' problems at the main shapes: the fused step and its
    inputs (clouds, no aerosols), the same problem's objects with the
    aerosol tables, and the non-banded configuration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    step, inputs = build_allsky_step(*MAIN, device=dev)
    return dict(step=step, inputs=inputs,
                prob=build_allsky(*MAIN, device=dev, use_aerosols=True),
                nonbanded=build_allsky(*MAIN_NONBANDED, device=dev,
                                       use_aerosols=True))


_GATHERS = ("gas_major", "gas_minor", "gas_rayleigh")
# case: (the kernels it launches at least once, those it launches once a
# step, the case it is held to: its configuration's fused step, or, by
# band, its broadband run summed over bands)
PATH_CASES = {
    "fused": (("cloud_props", "fused_lw", "fused_sw"), (), None),
    "api": (("cloud_props",) + _GATHERS + ("solver_lw", "solver_sw"), (),
            "fused"),
    "staged": (("cloud_props",) + _GATHERS
               + ("solver_lw_pfrac", "solver_sw_combined"), (), "fused"),
    "byband-fused": (("cloud_props",), ("fused_lw", "fused_sw"), "fused"),
    "two-stream": (("cloud_props", "gas_major", "gas_minor"),
                   ("solver_lw_2str",), None),
    "byband-two-stream": (("cloud_props", "gas_major", "gas_minor"),
                          ("solver_lw_2str",), "two-stream"),
    "nonbanded-fused": (("cloud_props", "fused_lw", "fused_sw"), (), None),
    "nonbanded-staged": (("cloud_props",) + _GATHERS
                         + ("solver_lw_lanes", "solver_sw_lanes"), (),
                         "nonbanded-fused"),
    "aerosols-fused": (("cloud_props", "fused_lw", "fused_sw"), (), None),
    "aerosols-staged": (("cloud_props",) + _GATHERS
                        + ("solver_lw_pfrac", "solver_sw_combined"), (),
                        "aerosols-fused"),
    "aerosols-api": (("cloud_props",) + _GATHERS + ("solver_lw",
                                                    "solver_sw"), (),
                     "aerosols-fused"),
    "clear-fused": (("fused_lw", "fused_sw"), (), None),
    "clear-staged": (_GATHERS + ("solver_lw_pfrac", "solver_sw_combined"),
                     (), "clear-fused"),
}


def _flagship_path(fl, case):
    """(step, inputs, problem) of a path case at the main shapes: a route
    (fused, api, staged, two-stream) in a configuration (clouds; by band;
    the non-banded widths; aerosols; clear sky)."""
    config, _, route = case.partition("-")
    if config not in ("byband", "nonbanded", "aerosols", "clear"):
        config, route = "", case
    opts = dict(aerosols=dict(use_aerosols=True),
                clear=dict(use_clouds=False)).get(config, {})
    p, inputs = ((fl["nonbanded"], fl["nonbanded"].inputs)
                 if config == "nonbanded" else (fl["prob"], fl["inputs"]))
    if route == "two-stream":
        return (_composed_step(p, route, byband=config == "byband"), inputs,
                p)
    if route == "fused" and config != "byband":
        step = (fl["step"] if not config else build_allsky_step(
            *(MAIN_NONBANDED if config == "nonbanded" else MAIN),
            device=inputs.play.device, **opts)[0])
        return step, inputs, p
    if config == "byband":
        return _composed_step(p, "step", byband=True), inputs, p
    return _composed_step(p, route, **opts), inputs, p


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_paths_launch_and_agree_at_main_shapes(cuda, flagship, case):
    """Each path at 4096 x 72 (the non-banded configuration at LW 192 /
    SW 168 g-points): the kernels it must launch at least once (cloud
    optics not without clouds), the fused kernels by band and the
    two-stream kernel once a step, the scaling rows and the descriptors
    (and with aerosols their lookup) once per gas-optics call (2 a step; 1
    on the LW-only two-stream path), no other kernel; finite (ncol, nlay+1[, nband]) fluxes, non-negative
    but the two-stream path's by band (float32 rounding of the Toon
    sources leaves some bands' near-zero downward flux in the top layers
    below zero, as in the float32 twin); TOA SW down the solar source
    times mu0 (rel 1e-5); held against its reference within rtol 3e-5 /
    atol 5e-4 W/m2."""
    launched, once, ref_case = PATH_CASES[case]
    step, inputs, p = _flagship_path(flagship, case)
    out, got = _launches(lambda: step(inputs))
    nprep = 1 if case.endswith("two-stream") else 2
    _assert_launches(got, dict({k: 1 for k in once}, minor_scale=nprep,
                               gas_descriptors=nprep,
                               aerosol_props=2 * case.startswith("aerosols")),
                     launched)
    ncol, nlay = inputs.play.shape
    for o in out:
        assert tuple(o.shape[:2]) == (ncol, nlay + 1)
        assert bool(torch.isfinite(o).all())
        if case != "byband-two-stream":
            assert not bool((o < 0).any())
    if len(out) == 5 and not case.startswith("byband"):
        solar = float(p.gas_sw.kdist.solar_source.double().sum())
        toa = solar * inputs.mu0.double()
        assert float(((out[3][:, 0].double() - toa).abs() / toa).max()) \
            <= 1e-5
    if ref_case is not None:
        ref_step, ref_inputs, _ = _flagship_path(flagship, ref_case)
        ref = ref_step(ref_inputs)
        if case.startswith("byband"):
            out = tuple(o.sum(-1) for o in out)
        _paths_agree(out, ref)


@pytest.mark.parametrize("angles", ["3 gauss", "optimal"])
def test_rte_lw_angles_match_cpu_twins(cuda, flagship, angles):
    """rte_lw with 3 Gauss quadrature angles and with per-(column,
    g-point) optimal-angle secants, on 512 columns of the main problem:
    on the card against the same call on the CPU (the twins), within 2e-6
    of the largest flux (the TOL_FLUX rule)."""
    import dataclasses
    from rte_rrtmgp_tpu_torch.rte import rte_lw
    from rte_rrtmgp_tpu_torch.optical_props import subset
    from rte_rrtmgp_tpu_torch.sources import subset_sources
    n, p, i = 512, flagship["prob"], flagship["inputs"]
    props, src = p.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                        i.gas_concs, tlev=i.tlev,
                                        top_at_1=True)
    props, src = subset(props, 0, n), subset_sources(src, 0, n)
    emis = i.sfc_emis[:n]
    cpu = lambda x: x.cpu() if hasattr(x, "cpu") else x
    props_c = dataclasses.replace(props, tau=props.tau.cpu())
    src_c = dataclasses.replace(src, **{f: cpu(getattr(src, f)) for f in (
        "lay_source", "lev_source", "sfc_source", "sfc_source_jac")})
    if angles == "3 gauss":
        kw = kw_c = dict(n_gauss_angles=3)
    else:
        ds = p.gas_lw.compute_optimal_angles(props)
        kw, kw_c = dict(lw_ds=ds), dict(lw_ds=ds.cpu())
    got = rte_lw(props, src, emis, **kw)
    ref = rte_lw(props_c, src_c, emis.cpu(), **kw_c)
    _flux_close((got.flux_up.cpu(), got.flux_dn.cpu()),
                (ref.flux_up, ref.flux_dn))


@pytest.mark.parametrize("kernel", ["fused_lw", "fused_sw", "solver_lw",
                                    "solver_lw_2str", "solver_sw",
                                    "solver_lw_bwd", "solver_sw_bwd",
                                    "occupancy"])
def test_kernel_resources_at_main_shapes(cuda, flagship, kernel):
    """The resources chip_smoke.py prints at the main path's shapes. Each
    kernel that holds its transport on chip, broadband and by band
    (solver_lw also rescaled with the Jacobian and PFRAC; solver_sw also
    COMBINED): the shared memory per block that onchip_geometry counts
    equal to the launcher's own count, at least one resident block per SM
    and, in a cluster, one cluster at a time, no device scratch. The fused
    adjoints (rows 16, 17) and the minor, Rayleigh and major gathers: at
    least one resident block per SM."""
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw as flw
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_sw as fsw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw as slw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_2str as l2
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_bwd as lwb
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw as ss
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw_bwd as ssw
    from rte_rrtmgp_tpu_torch.ops.kernels._build import library
    p = flagship["prob"]
    ncol, nlay = p.inputs.play.shape
    ngl, nbl = p.gas_lw.ngpt, p.gas_lw.grid.nband
    ngs, nbs = p.gas_sw.ngpt, p.gas_sw.grid.nband
    xl = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
    xs = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
    if kernel == "occupancy":
        from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (
            gas_major_occupancy)
        from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (
            gas_minor_occupancy, gas_rayleigh_occupancy)
        assert flw.lw_fused_bwd_occupancy(xl) >= 1
        assert fsw.sw_fused_bwd_occupancy(xs) >= 1
        for gas in (p.gas_lw, p.gas_sw):
            for mset in (gas.kdist.minor_lower, gas.kdist.minor_upper):
                assert gas_minor_occupancy(gas.ngpt, len(mset)) >= 1
        assert gas_rayleigh_occupancy(ngs) >= 1
        for ngpt, planck in ((ngl, True), (ngs, False),
                             (MAIN_NONBANDED[2], True)):
            assert gas_major_occupancy(ngpt, planck) >= 1
        return
    lib = library(kernel)
    cases = []      # (geometry, occupancy, the launcher's shared memory,
    #                  scratch bytes)
    if kernel == "fused_lw":
        for nband in (0, nbl):
            x = xl._replace(byband=nband > 0)
            geo = flw.lw_fused_geometry(x)
            cases.append((geo, flw.lw_fused_occupancy(x), lib.smem_fused_lw(
                nlay, geo.chunk, len(xl.minors), nband),
                flw.lw_fused_scratch_bytes(ncol, nlay, ngl)))
    elif kernel == "fused_sw":
        for nband in (0, xs.nband):
            x = xs._replace(byband=nband > 0, nband=nband)
            geo = fsw.sw_fused_geometry(x)
            cases.append((geo, fsw.sw_fused_occupancy(x), lib.smem_fused_sw(
                nlay, geo.chunk, len(xs.minors), nband),
                fsw.sw_fused_scratch_bytes(ncol, nlay, ngs)))
    elif kernel == "solver_lw":
        for nband, rescale, pfrac in ((0, False, False), (nbl, False, False),
                                      (0, True, False), (nbl, True, False),
                                      (0, False, True)):
            v = dict(rescale=rescale, jacobian=rescale, pfrac=pfrac)
            geo = slw.lw_noscat_geometry(nlay, ngl, nband, **v)
            cases.append((geo, slw.lw_noscat_occupancy(nlay, ngl, nband, **v),
                          lib.smem_solver_lw(nlay, geo.chunk, nband,
                                             int(rescale), int(rescale),
                                             int(pfrac)),
                          slw.lw_noscat_scratch_bytes(ncol, nlay, ngl)))
    elif kernel == "solver_lw_2str":
        for nband in (0, nbl):
            geo = l2.lw_2stream_geometry(nlay, ngl, nband)
            cases.append((geo, l2.lw_2stream_occupancy(nlay, ngl, nband),
                          lib.smem_solver_lw_2str(nlay, geo.chunk, nband),
                          l2.lw_2stream_scratch_bytes(ncol, nlay, ngl)))
    elif kernel == "solver_sw":
        for nband, combined in ((0, False), (nbs, False), (0, True)):
            geo = ss.sw_2stream_geometry(nlay, ngs, nband)
            cases.append((geo, ss.sw_2stream_occupancy(
                nlay, ngs, nband, combined=combined),
                lib.smem_solver_sw(nlay, geo.chunk, nband),
                ss.sw_2stream_scratch_bytes(ncol, nlay, ngs)))
    elif kernel == "solver_lw_bwd":
        geo = lwb.lw_noscat_bwd_geometry(nlay, ngl)
        cases.append((geo, (lwb.lw_noscat_bwd_occupancy(nlay, ngl), None),
                      lib.smem_solver_lw_bwd(nlay, geo.chunk),
                      lwb.lw_noscat_bwd_scratch_bytes(ncol, nlay, ngl)))
    else:
        geo = ssw.sw_2stream_bwd_geometry(nlay, ngs)
        cases.append((geo, ssw.sw_2stream_bwd_occupancy(nlay, ngs),
                      lib.smem_solver_sw_bwd(nlay, geo.chunk),
                      ssw.sw_2stream_bwd_scratch_bytes(ncol, nlay, ngs)))
    for geo, (blocks, clusters), smem, scratch in cases:
        assert smem == geo.smem, (smem, geo.smem)
        assert blocks >= 1 and (clusters is None or clusters >= 1)
        assert scratch == 0
