"""The port's LW solve: rte_lw, ops/solver_lw and the solver_lw twin.

  * The cases of tests/test_lw_solver.py, one for one, on the gray
    radiative-equilibrium problem of tests/gray_atmosphere.py (its arrays
    handed to the port's containers): the analytic OLR, invariances, the
    surface Jacobian against a finite difference and against autograd,
    Tang rescaling with ssa = 0, explicit secants, multi-angle quadrature,
    spectral output, float32. The LW two-stream solver runs through its
    kernel wrapper (the twin on the CPU); with absorption-only props it
    must raise.
  * The one-angle twin (``lw_noscat_plain``, reached through the port's
    ``lw_solver_noscat`` on CPU tensors) against the JAX package on the
    same numpy-seeded inputs, with and without rescaling, Jacobian and
    per-(column, g-point) secants, both orientations: in float32 against
    the Pallas kernel ``lw_noscat_broadband_lane`` in interpret mode (the
    two sum g-points and layers in other orders; bound 2e-6 of the largest
    flux), and in float64 against the XLA path (bound 1e-12).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gray_atmosphere import (D, SIGMA, gray_rad_equil,  # noqa: E402
                             gray_rad_equil_olr)
from rte_rrtmgp_tpu import rte_lw as jrte_lw  # noqa: E402
from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.ops import solver_lw as jsolver  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import lw_noscat  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (  # noqa: E402
    lw_2stream, lw_2stream_plain)
from rte_rrtmgp_tpu_torch.ops.solver_lw import (GAUSS_DS,  # noqa: E402
                                                GAUSS_WTS, lw_solver_noscat)
from rte_rrtmgp_tpu_torch.optical_props import (  # noqa: E402
    OpticalProps1scl, OpticalProps2str, subset)
from rte_rrtmgp_tpu_torch.rte import rte_lw  # noqa: E402
from rte_rrtmgp_tpu_torch.sources import SourcesLW, subset_sources  # noqa: E402
from rte_rrtmgp_tpu_torch.spectral import SpectralGrid  # noqa: E402

NCOL, NLAY = 8, 16
SFC_T = np.array([285.0] * 4 + [310.0] * 4)
TOTAL_TAU = np.array([0.1, 1.0, 10.0, 50.0] * 2)
SFC_EMIS = np.ones((NCOL, 1))
F64 = torch.float64


def gray(top_at_1=True, dtype=F64, sfc_t=SFC_T):
    """The gray-equilibrium problem as the port's containers."""
    jprops, jsrc = gray_rad_equil(sfc_t, TOTAL_TAU, NLAY, top_at_1=top_at_1)
    grid = SpectralGrid(band_lims_wvn=jprops.grid.band_lims_wvn,
                        band_lims_gpt=jprops.grid.band_lims_gpt)
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype)
    props = OpticalProps1scl(tau=t(jprops.tau), grid=grid, top_at_1=top_at_1)
    src = SourcesLW(lay_source=t(jsrc.lay_source),
                    lev_source=t(jsrc.lev_source),
                    sfc_source=t(jsrc.sfc_source),
                    sfc_source_jac=t(jsrc.sfc_source_jac), grid=grid)
    return props, src


@pytest.fixture(scope="module")
def ref_fluxes():
    props, src = gray()
    return rte_lw(props, src, SFC_EMIS)


def test_gray_rad_equil_olr(ref_fluxes):
    np.testing.assert_allclose(ref_fluxes.flux_up[:, 0].numpy(),
                               gray_rad_equil_olr(SFC_T, TOTAL_TAU),
                               rtol=1e-10)


def test_net_flux_constant_with_height(ref_fluxes):
    net = ref_fluxes.flux_net.numpy()
    np.testing.assert_allclose(net, np.broadcast_to(net[:, :1], net.shape),
                               rtol=1e-9)


def test_net_is_dn_minus_up(ref_fluxes):
    assert torch.equal(ref_fluxes.flux_net,
                       ref_fluxes.flux_dn - ref_fluxes.flux_up)


def test_subset_invariance(ref_fluxes):
    props, src = gray()
    h = NCOL // 2
    parts = [rte_lw(subset(props, s, h), subset_sources(src, s, h),
                    SFC_EMIS[s:s + h]) for s in (0, h)]
    assert torch.equal(torch.cat([p.flux_up for p in parts]),
                       ref_fluxes.flux_up)
    assert torch.equal(torch.cat([p.flux_dn for p in parts]),
                       ref_fluxes.flux_dn)


def test_vertical_orientation_invariance(ref_fluxes):
    props, src = gray(top_at_1=False)
    f = rte_lw(props, src, SFC_EMIS)
    np.testing.assert_allclose(f.flux_up.numpy()[:, ::-1],
                               ref_fluxes.flux_up.numpy(), rtol=1e-12)
    np.testing.assert_allclose(f.flux_dn.numpy()[:, ::-1],
                               ref_fluxes.flux_dn.numpy(), rtol=1e-12)


def test_jacobian_does_not_change_fluxes(ref_fluxes):
    props, src = gray()
    f = rte_lw(props, src, SFC_EMIS, compute_jacobian=True)
    assert torch.equal(f.flux_up, ref_fluxes.flux_up)
    assert f.flux_up_jac is not None


def test_jacobian_vs_finite_difference():
    props, src = gray()
    f0 = rte_lw(props, src, SFC_EMIS, compute_jacobian=True)
    tp = SFC_T + 1.0
    src_p = dataclasses.replace(
        src, sfc_source=torch.as_tensor((SIGMA / np.pi * tp ** 4)[:, None]),
        sfc_source_jac=torch.as_tensor((4 * SIGMA / np.pi * tp ** 3)[:, None]))
    f1 = rte_lw(props, src_p, SFC_EMIS)
    np.testing.assert_allclose((f1.flux_up - f0.flux_up).numpy(),
                               f0.flux_up_jac.numpy(), rtol=2e-2, atol=1e-6)


def test_rescaled_2str_purely_absorbing_matches_1scl(ref_fluxes):
    props, src = gray()
    props2 = OpticalProps2str(tau=props.tau, ssa=torch.zeros_like(props.tau),
                              g=torch.zeros_like(props.tau), grid=props.grid)
    f = rte_lw(props2, src, SFC_EMIS, compute_jacobian=True)
    np.testing.assert_allclose(f.flux_up.numpy(), ref_fluxes.flux_up.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(f.flux_dn.numpy(), ref_fluxes.flux_dn.numpy(),
                               rtol=1e-12)


def test_explicit_diffusivity_angle_matches_default(ref_fluxes):
    props, src = gray()
    f = rte_lw(props, src, SFC_EMIS, lw_ds=np.full((NCOL, 1), D))
    np.testing.assert_allclose(f.flux_up.numpy(), ref_fluxes.flux_up.numpy(),
                               rtol=1e-12)


def test_multi_angle_quadrature_converges():
    props, src = gray()
    olr = gray_rad_equil_olr(SFC_T, TOTAL_TAU)
    f3 = rte_lw(props, src, SFC_EMIS, n_gauss_angles=3)
    f4 = rte_lw(props, src, SFC_EMIS, n_gauss_angles=4)
    np.testing.assert_allclose(f3.flux_up[:, 0].numpy(), olr, rtol=5e-2)
    np.testing.assert_allclose(f4.flux_up[:, 0].numpy(),
                               f3.flux_up[:, 0].numpy(), rtol=1e-3)


def test_two_stream_solver_not_ported_raises():
    """The LW two-stream solver runs: use_2stream with 2str props goes
    through the kernel wrapper ``lw_2stream`` (its twin on the CPU, no
    launch) and gives the twin's broadband fluxes; with absorption-only
    props it raises instead of running another solver."""
    props, src = gray()
    props2 = OpticalProps2str(tau=props.tau, ssa=torch.zeros_like(props.tau),
                              g=torch.zeros_like(props.tau), grid=props.grid)
    n0 = lw_2stream.launches
    f = rte_lw(props2, src, SFC_EMIS, use_2stream=True)
    assert lw_2stream.launches == n0
    emis = torch.ones((NCOL, 1), dtype=F64)
    up, dn = lw_2stream_plain(props.tau, props2.ssa, props2.g,
                              src.lay_source, src.lev_source, emis,
                              src.sfc_source, torch.zeros_like(emis))
    assert torch.equal(f.flux_up, up) and torch.equal(f.flux_dn, dn)
    with pytest.raises(ValueError, match="absorption"):
        rte_lw(props, src, SFC_EMIS, use_2stream=True)


def test_spectral_output_sums_to_broadband(ref_fluxes):
    props, src = gray()
    f = rte_lw(props, src, SFC_EMIS, spectral=True)
    np.testing.assert_allclose(f.flux_up.sum(-1).numpy(),
                               ref_fluxes.flux_up.numpy(), rtol=1e-12)


def test_float32_accuracy():
    props, src = gray(dtype=torch.float32)
    f = rte_lw(props, src, np.ones((NCOL, 1), np.float32))
    assert f.flux_up.dtype == torch.float32
    olr = gray_rad_equil_olr(SFC_T, TOTAL_TAU)
    assert np.max(np.abs(f.flux_up[:, 0].numpy() - olr)) < 3.5e-1


def test_jacobian_vs_autograd():
    """The analytic surface-temperature Jacobian equals autograd's
    derivative through the twin when the surface source is sigma T^4/pi."""
    props, src = gray()
    f0 = rte_lw(props, src, SFC_EMIS, compute_jacobian=True)
    tsfc = torch.as_tensor(SFC_T, dtype=F64).requires_grad_(True)
    src_t = dataclasses.replace(
        src, sfc_source=(SIGMA / np.pi * tsfc ** 4)[:, None],
        sfc_source_jac=torch.zeros((NCOL, 1), dtype=F64))
    up = rte_lw(props, src_t, SFC_EMIS).flux_up
    diag = torch.stack([torch.autograd.grad(up[:, k].sum(), tsfc,
                                            retain_graph=True)[0]
                        for k in range(NLAY + 1)], dim=1)
    np.testing.assert_allclose(diag.numpy(), f0.flux_up_jac.numpy(),
                               rtol=1e-10, atol=1e-13)


def test_rte_lw_checks():
    props, src = gray()
    with pytest.raises(ValueError, match="n_gauss_angles"):
        rte_lw(props, src, SFC_EMIS, n_gauss_angles=5)
    with pytest.raises(ValueError, match="lw_ds"):
        rte_lw(props, src, SFC_EMIS, lw_ds=np.full((NCOL, 1), D),
               n_gauss_angles=2)
    with pytest.raises(ValueError, match="exclusive"):
        rte_lw(props, src, SFC_EMIS, byband=True, spectral=True)
    with pytest.raises(ValueError, match="sfc_emis"):
        rte_lw(props, src, np.ones((NCOL, 3)))
    bad = dataclasses.replace(props, tau=-props.tau)
    with pytest.raises(ValueError, match="tau"):
        rte_lw(bad, src, SFC_EMIS)


# ---------------------------------------------------------------------------
# the twin against the JAX package
# ---------------------------------------------------------------------------

SHAPE = (5, 9, 20)


def solver_inputs(seed=5):
    """Random one-angle solve inputs of tests/test_pallas_gas_optics.py."""
    rng = np.random.default_rng(seed)
    ncol, nlay, ngpt = SHAPE
    return dict(
        tau=rng.uniform(1e-3, 3.0, SHAPE), lay=rng.uniform(10, 60, SHAPE),
        lev=rng.uniform(10, 60, (ncol, nlay + 1, ngpt)),
        emis=rng.uniform(0.9, 1.0, (ncol, ngpt)),
        sfc=rng.uniform(30, 80, (ncol, ngpt)),
        jac=rng.uniform(0.1, 1.0, (ncol, ngpt)),
        inc=rng.uniform(0, 5, (ncol, ngpt)),
        ssa=rng.uniform(0, 0.7, SHAPE), g=rng.uniform(0, 0.8, SHAPE),
        ds=rng.uniform(1.4, 1.9, (ncol, ngpt)))


@pytest.mark.parametrize("dtype,pallas,tol", [
    ("float32", True, 2e-6), ("float64", False, 1e-12)],
    ids=["f32-pallas-interpret", "f64-xla"])
@pytest.mark.parametrize("rescale,jacobian,per_gpt_ds,top_at_1", [
    (False, False, False, True), (True, True, False, True),
    (False, True, True, False), (True, False, True, False)],
    ids=["plain", "rescale-jac", "jac-ds-flip", "rescale-ds-flip"])
def test_lw_noscat_twin_matches_jax(dtype, pallas, tol, rescale, jacobian,
                                    per_gpt_ds, top_at_1):
    a = solver_inputs()
    t = {k: torch.as_tensor(v, dtype=getattr(torch, dtype))
         for k, v in a.items()}
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in a.items()}
    tds = t["ds"][None] if per_gpt_ds else GAUSS_DS[0]
    jds = j["ds"][None] if per_gpt_ds else np.asarray(GAUSS_DS[0])
    kw = dict(top_at_1=top_at_1, weights=GAUSS_WTS[0],
              do_rescaling=rescale, do_jacobians=jacobian)
    extra = lambda d: dict(sfc_src_jac=d["jac"], ssa=d["ssa"], g=d["g"])
    n0 = lw_noscat.launches
    got = lw_solver_noscat(t["tau"], t["lay"], t["lev"], t["emis"], t["sfc"],
                           t["inc"], ds=tds, **kw, **extra(t))
    assert lw_noscat.launches == n0, "a CPU tensor must not reach the kernel"
    set_use_pallas(pallas)
    try:
        ref = jsolver.lw_solver_noscat(j["tau"], j["lay"], j["lev"],
                                       j["emis"], j["sfc"], j["inc"],
                                       ds=jds, **kw, **extra(j))
    finally:
        set_use_pallas(None)
    pairs = [(got.flux_up, ref.flux_up), (got.flux_dn, ref.flux_dn)]
    if jacobian:
        pairs.append((got.flux_up_jac, ref.flux_up_jac))
    else:
        assert got.flux_up_jac is None
    for g, r in pairs:
        r = np.asarray(r)
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == r.shape
        err = np.abs(g.numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (err, tol * np.abs(r).max())


@pytest.mark.parametrize("angles", [2, 3, 4, "lw_ds"])
def test_rte_lw_angles_match_jax(angles):
    """Multi-angle quadrature and user secants through rte_lw, float64,
    against the JAX package's rte_lw (XLA path)."""
    props, src = gray()
    jprops, jsrc = gray_rad_equil(SFC_T, TOTAL_TAU, NLAY)
    ds = np.random.default_rng(2).uniform(1.5, 1.8, (NCOL, 1))
    kw = (dict(lw_ds=ds) if angles == "lw_ds"
          else dict(n_gauss_angles=angles))
    got = rte_lw(props, src, SFC_EMIS, compute_jacobian=True, **kw)
    ref = jrte_lw(jprops, jsrc, jnp.asarray(SFC_EMIS), compute_jacobian=True,
                  **kw)
    for name in ("flux_up", "flux_dn", "flux_up_jac"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-12)
