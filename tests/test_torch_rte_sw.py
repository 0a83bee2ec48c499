"""The port's SW solve: rte_sw, ops/solver_sw and the solver_sw twin.

  * The cases of tests/test_sw_solver.py, one for one, on its thin
    scattering atmospheres (mu0 1.0 and 0.5): Beer-Lambert direct beam,
    invariances, linearity in the TOA flux, energy conservation, night,
    spectral output, the direct-beam-only solver, mu0 by layer, and the
    closed-form Meador-Weaver oracles (the independent hyperbolic form,
    the conservative and thin limits, single-layer composition); plus the
    r5 regressions of the direct beam at night and of inc_flux_dif with
    absorption-only props (tests/test_r5_regressions.py).
  * The two-stream twin (``sw_2stream_plain``, reached through the port's
    ``sw_solver_2stream`` on CPU tensors) against the JAX package on the
    same numpy-seeded inputs with night columns, with and without a
    diffuse incident flux, both orientations: in float32 against the
    Pallas kernel ``sw_two_stream_broadband_lane`` in interpret mode
    (bound 2e-6 of the largest flux), in float64 against the XLA path
    (bound 1e-12).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.ops import solver_sw as jsolver  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import sw_2stream  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.solver_sw import (  # noqa: E402
    sw_dif_and_source, sw_solver_2stream)
from rte_rrtmgp_tpu_torch.optical_props import (  # noqa: E402
    OpticalProps1scl, OpticalProps2str, subset)
from rte_rrtmgp_tpu_torch.rte import rte_sw  # noqa: E402
from rte_rrtmgp_tpu_torch.spectral import SpectralGrid  # noqa: E402

NCOL, NLAY = 8, 16
GRID = SpectralGrid.from_arrays([[3250.0, 10000.0]], [[1, 1]])
F64 = torch.float64
TOA_FLUX = np.ones((NCOL, 1))
ALB = np.zeros((NCOL, 1))


def thin_scattering(dtype=F64):
    """8 columns spanning tau {1e-4, 1e-2} x ssa {1-1e-4, 1-1e-2} x g
    {0.85, 0.65} (reference thin_scattering setup)."""
    cols = [(t, s, g) for t in (1.0e-4, 1.0e-2)
            for s in (1.0 - 1.0e-4, 1.0 - 1.0e-2) for g in (0.85, 0.65)]
    field = lambda i, scale: torch.as_tensor(
        np.array([[c[i] * scale] * NLAY for c in cols])[:, :, None],
        dtype=dtype)
    return OpticalProps2str(tau=field(0, 1.0 / NLAY), ssa=field(1, 1.0),
                            g=field(2, 1.0), grid=GRID)


@pytest.fixture(scope="module", params=[1.0, 0.5])
def mu0_and_fluxes(request):
    mu0 = np.full(NCOL, request.param)
    atmos = thin_scattering()
    return mu0, atmos, rte_sw(atmos, mu0, TOA_FLUX, ALB, ALB)


def test_direct_beam_beer_lambert(mu0_and_fluxes):
    mu0, atmos, f = mu0_and_fluxes
    total_tau = atmos.tau.sum(dim=(1, 2)).numpy()
    np.testing.assert_allclose(f.flux_dn_dir[:, -1].numpy(),
                               mu0 * np.exp(-total_tau / mu0), rtol=1e-12)


def test_net_is_dn_minus_up(mu0_and_fluxes):
    _, _, f = mu0_and_fluxes
    assert torch.equal(f.flux_net, f.flux_dn - f.flux_up)


def test_subset_invariance(mu0_and_fluxes):
    mu0, atmos, ref = mu0_and_fluxes
    h = NCOL // 2
    parts = [rte_sw(subset(atmos, s, h), mu0[s:s + h], TOA_FLUX[s:s + h],
                    ALB[s:s + h], ALB[s:s + h]) for s in (0, h)]
    assert torch.equal(torch.cat([p.flux_up for p in parts]), ref.flux_up)
    assert torch.equal(torch.cat([p.flux_dn for p in parts]), ref.flux_dn)


def test_vertical_orientation_invariance(mu0_and_fluxes):
    mu0, atmos, ref = mu0_and_fluxes
    flipped = OpticalProps2str(tau=torch.flip(atmos.tau, [1]),
                               ssa=torch.flip(atmos.ssa, [1]),
                               g=torch.flip(atmos.g, [1]), grid=GRID,
                               top_at_1=False)
    f = rte_sw(flipped, mu0, TOA_FLUX, ALB, ALB)
    np.testing.assert_allclose(f.flux_up.numpy()[:, ::-1],
                               ref.flux_up.numpy(), rtol=1e-12)
    np.testing.assert_allclose(f.flux_dn.numpy()[:, ::-1],
                               ref.flux_dn.numpy(), rtol=1e-12)


def test_linear_in_toa_flux(mu0_and_fluxes):
    mu0, atmos, ref = mu0_and_fluxes
    f = rte_sw(atmos, mu0, 2.0 * TOA_FLUX, ALB, ALB)
    np.testing.assert_allclose(f.flux_up.numpy(), 2.0 * ref.flux_up.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(f.flux_dn.numpy(), 2.0 * ref.flux_dn.numpy(),
                               rtol=1e-12)


def test_energy_conservation(mu0_and_fluxes):
    mu0, atmos, f = mu0_and_fluxes
    inc = TOA_FLUX[:, 0] * mu0
    bal = (f.flux_up[:, 0] + f.flux_dn[:, -1]).numpy()
    assert np.all(bal <= inc * (1 + 1e-10))
    np.testing.assert_allclose(bal, inc, rtol=2e-2)


def test_spectral_output_sums_to_broadband(mu0_and_fluxes):
    mu0, atmos, ref = mu0_and_fluxes
    f = rte_sw(atmos, mu0, TOA_FLUX, ALB, ALB, spectral=True)
    np.testing.assert_allclose(f.flux_up.sum(-1).numpy(), ref.flux_up.numpy(),
                               rtol=1e-12)


def test_byband_equals_broadband_for_one_band(mu0_and_fluxes):
    mu0, atmos, ref = mu0_and_fluxes
    f = rte_sw(atmos, mu0, TOA_FLUX, ALB, ALB, byband=True)
    np.testing.assert_allclose(f.flux_dn[..., 0].numpy(), ref.flux_dn.numpy(),
                               rtol=1e-12)


def test_nighttime_columns_zero():
    f = rte_sw(thin_scattering(), np.full(NCOL, -0.3), TOA_FLUX, ALB, ALB)
    assert bool((f.flux_up == 0.0).all())


def test_sw_noscat_direct_only():
    atmos = thin_scattering()
    props = OpticalProps1scl(tau=atmos.tau, grid=GRID)
    mu0 = np.full(NCOL, 0.7)
    f = rte_sw(props, mu0, TOA_FLUX, ALB, ALB)
    total_tau = atmos.tau.sum(dim=(1, 2)).numpy()
    np.testing.assert_allclose(f.flux_dn_dir[:, -1].numpy(),
                               mu0 * np.exp(-total_tau / mu0), rtol=1e-12)
    assert bool((f.flux_up == 0).all())


def test_mu0_by_layer_spherical():
    atmos = thin_scattering()
    ref = rte_sw(atmos, np.full(NCOL, 0.5), TOA_FLUX, ALB, ALB)
    f = rte_sw(atmos, np.full((NCOL, NLAY), 0.5), TOA_FLUX, ALB, ALB)
    assert torch.equal(f.flux_up, ref.flux_up)


def test_sw_noscat_night_columns_zero():
    """The direct-beam solver carries no beam through night columns (the
    r5 fix: it divided by raw mu0)."""
    rng = np.random.default_rng(0)
    ngpt = 8
    grid = SpectralGrid.from_arrays(np.array([[10.0, 3000.0]]),
                                    np.array([[1, ngpt]]))
    props = OpticalProps1scl(tau=torch.as_tensor(
        rng.uniform(0.1, 50.0, (4, 5, ngpt)), dtype=torch.float32), grid=grid)
    f = rte_sw(props, np.array([0.6, -0.3, 0.0, 0.8], np.float32),
               np.full((4, ngpt), 100.0, np.float32), np.zeros((4, 1)),
               np.zeros((4, 1)))
    dn = f.flux_dn.numpy()
    assert np.isfinite(dn).all()
    assert np.all(dn[1] == 0.0) and np.all(dn[2] == 0.0)
    assert dn[0, 0] > 0.0 and dn[3, 0] > 0.0


def test_rte_sw_checks():
    atmos = thin_scattering()
    props = OpticalProps1scl(tau=atmos.tau, grid=GRID)
    with pytest.raises(ValueError, match="inc_flux_dif"):
        rte_sw(props, np.full(NCOL, 0.5), TOA_FLUX, ALB, ALB,
               inc_flux_dif=TOA_FLUX)
    with pytest.raises(ValueError, match="mu0"):
        rte_sw(atmos, np.full(NCOL, 1.5), TOA_FLUX, ALB, ALB)
    with pytest.raises(ValueError, match="mu0 shape"):
        rte_sw(atmos, np.full((NCOL, 3), 0.5), TOA_FLUX, ALB, ALB)
    with pytest.raises(ValueError, match="exclusive"):
        rte_sw(atmos, np.full(NCOL, 0.5), TOA_FLUX, ALB, ALB, byband=True,
               spectral=True)


# ---------------------------------------------------------------------------
# closed-form Meador-Weaver oracles (reference rte_sw_solver_unit_tests)
# ---------------------------------------------------------------------------

def _mw_hyperbolic(tau, w0, g, mu0):
    """Meador-Weaver R/T in float64 via the hyperbolic-function form,
    with the reference's energy clamps."""
    tau, w0, g = (np.asarray(x, np.float64) for x in (tau, w0, g))
    gamma1 = (8.0 - w0 * (5.0 + 3.0 * g)) / 4.0
    gamma2 = 3.0 * w0 * (1.0 - g) / 4.0
    gamma3 = (2.0 - 3.0 * mu0 * g) / 4.0
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    k = np.sqrt((gamma1 - gamma2) * (gamma1 + gamma2))
    ch, sh = np.cosh(k * tau), np.sinh(k * tau)
    den = k * ch + gamma1 * sh
    t0 = np.exp(-tau / mu0)
    pre = w0 / (2.0 * (1.0 - (k * mu0) ** 2) * den)
    rdir = pre * ((1.0 - k * mu0) * (alpha2 + k * gamma3) * np.exp(k * tau)
                  - (1.0 + k * mu0) * (alpha2 - k * gamma3) * np.exp(-k * tau)
                  - 2.0 * k * (gamma3 - alpha2 * mu0) * t0)
    tdir = -pre * ((1.0 + k * mu0) * (alpha1 + k * gamma4) * t0
                   * np.exp(k * tau)
                   - (1.0 - k * mu0) * (alpha1 - k * gamma4) * t0
                   * np.exp(-k * tau)
                   - 2.0 * k * (gamma4 + alpha1 * mu0))
    rdir = np.clip(rdir, 0.0, 1.0 - t0)
    tdir = np.clip(tdir, 0.0, 1.0 - t0 - rdir)
    return gamma2 * sh / den, k / den, rdir, tdir


def _layer_rt(tau, w0, g, mu0):
    """Single-layer (rdif, tdif, rdir, tdir) from the port's
    sw_dif_and_source with unit incident direct flux."""
    shape = np.broadcast(np.asarray(tau), np.asarray(w0), np.asarray(g)).shape
    n = int(np.prod(shape)) or 1
    mk = lambda x: torch.as_tensor(
        np.array(np.broadcast_to(x, shape)).reshape(n, 1, 1), dtype=F64)
    rdif, tdif, sdn, sup, _, _ = sw_dif_and_source(
        mk(tau), mk(w0), mk(g), torch.full((n, 1), mu0, dtype=F64),
        torch.full((n, 1), 1.0 / mu0, dtype=F64),
        torch.zeros((n, 1), dtype=F64))
    r = lambda a: a.numpy().reshape(-1)
    return r(rdif), r(tdif), r(sup), r(sdn)


@pytest.mark.parametrize("mu0", [1.0, 0.7, 0.3])
def test_meador_weaver_closed_form(mu0):
    t, s, g = np.meshgrid(np.array([1e-4, 1e-2, 0.1, 1.0, 5.0]),
                          np.array([0.1, 0.5, 0.9, 0.999]),
                          np.array([0.0, 0.45, 0.85]), indexing="ij")
    got = _layer_rt(t, s, g, mu0)
    want = [x.reshape(-1) for x in _mw_hyperbolic(t, s, g, mu0)]
    for i, (a, b) in enumerate(zip(got, want)):
        rtol, atol = (1e-10, 1e-14) if i < 2 else (1e-8, 1e-13)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_meador_weaver_conservative_limit():
    tau, g, mu0 = np.array([1e-3, 0.1, 1.0, 10.0]), 0.6, 0.8
    rdif, tdif, rdir, tdir = _layer_rt(tau, 1.0, g, mu0)
    gamma1 = (8.0 - (5.0 + 3.0 * g)) / 4.0
    gamma2 = 3.0 * (1.0 - g) / 4.0
    np.testing.assert_allclose(rdif, gamma2 * tau / (1.0 + gamma1 * tau),
                               rtol=1e-6)
    np.testing.assert_allclose(tdif, 1.0 / (1.0 + gamma1 * tau), rtol=1e-6)
    np.testing.assert_allclose(rdif + tdif, 1.0, rtol=1e-9)
    np.testing.assert_allclose(rdir + tdir + np.exp(-tau / mu0), 1.0,
                               rtol=1e-6)


def test_meador_weaver_thin_limit():
    tau, w0, g, mu0 = 1e-5, 0.9, 0.5, 0.6
    rdif, tdif, rdir, tdir = _layer_rt(tau, w0, g, mu0)
    gamma1 = (8.0 - w0 * (5.0 + 3.0 * g)) / 4.0
    gamma2 = 3.0 * w0 * (1.0 - g) / 4.0
    gamma3 = (2.0 - 3.0 * mu0 * g) / 4.0
    np.testing.assert_allclose(rdif, gamma2 * tau, rtol=1e-3)
    np.testing.assert_allclose(1.0 - tdif, gamma1 * tau, rtol=1e-3)
    np.testing.assert_allclose(rdir, w0 * gamma3 * tau / mu0, rtol=1e-3)
    np.testing.assert_allclose(tdir, w0 * (1.0 - gamma3) * tau / mu0,
                               rtol=1e-3)


def test_single_layer_solver_composition():
    tau, w0, g, mu0 = 0.5, 0.8, 0.7, 0.9
    rdif, tdif, rdir, tdir = _layer_rt(tau, w0, g, mu0)
    full = lambda v: torch.full((1, 1, 1), v, dtype=F64)
    atmos = OpticalProps2str(tau=full(tau), ssa=full(w0), g=full(g),
                             grid=GRID)
    f = rte_sw(atmos, np.full(1, mu0), np.full((1, 1), 123.0),
               np.zeros((1, 1)), np.zeros((1, 1)))
    inc_dir = 123.0 * mu0
    np.testing.assert_allclose(float(f.flux_up[0, 0]), rdir[0] * inc_dir,
                               rtol=1e-12)
    np.testing.assert_allclose(float(f.flux_dn[0, 1]),
                               (tdir[0] + np.exp(-tau / mu0)) * inc_dir,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the twin against the JAX package
# ---------------------------------------------------------------------------

def solver_inputs(seed=11):
    """Random two-stream inputs of tests/test_pallas_gas_optics.py (5 x 9,
    20 g-points), mu0 by layer, from night (< 0) to overhead."""
    rng = np.random.default_rng(seed)
    ncol, nlay, ngpt = 5, 9, 20
    shape = (ncol, nlay, ngpt)
    mu_col = np.array([-0.2, 0.0, 0.05, 0.6, 1.0])
    return dict(
        tau=rng.uniform(1e-3, 2.0, shape), ssa=rng.uniform(0.1, 0.99, shape),
        g=rng.uniform(0.0, 0.85, shape),
        mu0=mu_col[:, None] * np.linspace(1.0, 0.95, nlay)[None, :],
        alb_dir=rng.uniform(0, 0.4, (ncol, ngpt)),
        alb_dif=rng.uniform(0, 0.4, (ncol, ngpt)),
        inc=rng.uniform(1, 8, (ncol, ngpt)), dif=rng.uniform(0, 1, (ncol, ngpt)))


@pytest.mark.parametrize("dtype,pallas,tol", [
    ("float32", True, 2e-6), ("float64", False, 1e-12)],
    ids=["f32-pallas-interpret", "f64-xla"])
@pytest.mark.parametrize("top_at_1", [True, False], ids=["top1", "flip"])
@pytest.mark.parametrize("diffuse", [False, True], ids=["nodif", "dif"])
def test_sw_2stream_twin_matches_jax(dtype, pallas, tol, top_at_1, diffuse):
    a = solver_inputs()
    t = {k: torch.as_tensor(v, dtype=getattr(torch, dtype))
         for k, v in a.items()}
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in a.items()}
    args = lambda d: (d["tau"], d["ssa"], d["g"], d["mu0"], d["alb_dir"],
                      d["alb_dif"], d["inc"])
    n0 = sw_2stream.launches
    got = sw_solver_2stream(*args(t), top_at_1=top_at_1,
                            inc_flux_dif=t["dif"] if diffuse else None)
    assert sw_2stream.launches == n0, "a CPU tensor must not reach the kernel"
    set_use_pallas(pallas)
    try:
        ref = jsolver.sw_solver_2stream(
            *args(j), top_at_1=top_at_1,
            inc_flux_dif=j["dif"] if diffuse else None)
    finally:
        set_use_pallas(None)
    for name in ("flux_up", "flux_dn", "flux_dir"):
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == r.shape
        err = np.abs(g.numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (name, err)
