"""The lane-layout solvers' plain twins against the JAX package's Pallas
kernels (``ops/pallas/solver_lanes.py``) run in interpret mode.

The same numpy-seeded inputs go to both, at ncol 128 and 136 (the TPU
kernels pad to 256 lanes), nlay 6, ngpt 24-32; the wrappers get CPU
tensors, so they run their twins and their launch counters stay put.

  * float64: the Pallas kernels keep float32's eps, tiny, min_mu0, min_k
    and the small-tau series threshold sqrt(sqrt(eps)) in every dtype
    (solver_lanes.py:76-78, :416-418, :705), the twins use their dtype's
    (as the JAX package's float64 XLA path does). The inputs keep clear
    of the ranges where the two sets differ: tau * ds (times the Tang
    scale, at least 0.1) above 0.0186, mu0 at night or above
    sqrt(eps32) = 3.5e-4, single-scattering albedos <= 0.96 so that
    k^2 > 1e4 eps32. Then the two agree to summation order: bound 1e-12
    of the largest flux.
  * float32: the same constants on both sides, so the full ranges,
    including a sun below the min_mu0 clamp (mu0 = 1e-4) and optical
    depths in the series window; bound 2e-6 of the largest flux (the two
    sum g-points and layers in other orders, with other exp roundings).

Cases: rescaling and the Jacobian on and off, the cloud on and off,
``inc_flux_dif`` given or absent, night columns (mu0 0 and negative) and
a low sun, mu0 varying by layer. The in-kernel-sources twin also takes
ragged bands (``gpt2band``), which the TPU kernel cannot: there it is held
against the plain lane twin fed with the same sources formed by hand.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.ops.pallas import solver_lanes as jlanes  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.gas_optics import level_pfrac  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lanes import (  # noqa: E402
    lw_noscat_lanes, lw_noscat_lanes_pfrac, sw_2stream_lanes,
    sw_2stream_lanes_combined)

NLAY = 6
DTYPES = {"f64": (np.float64, 1e-12), "f32": (np.float32, 2e-6)}
DS, WEIGHT = 1.66, 0.6


def rand(dtype, seed):
    rng = np.random.default_rng(seed)
    full = dtype == np.float32

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape)

    def tau(*shape):
        # float64: tau * DS, rescaled by at least 0.1, above 0.0186; a
        # zero row in float32 (with Rayleigh, a conservative layer)
        t = u(0.0 if full else 0.2, 2.0, *shape)
        if full:
            t[0] = 0.0
        return t
    return u, tau


def both(arrays, dtype):
    """The same arrays as JAX and torch inputs of one dtype."""
    j = [None if a is None else jnp.asarray(a, dtype) for a in arrays]
    t = [None if a is None else torch.as_tensor(np.asarray(a, dtype))
         for a in arrays]
    return j, t


def check(got, ref, tol):
    got = [g for g in got if g is not None]
    ref = [np.asarray(r) for r in ref if r is not None]
    assert len(got) == len(ref)
    scale = max(np.abs(r).max() for r in ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        err = np.abs(g.numpy().astype(np.float64) - r).max()
        assert err <= tol * scale, (err, tol * scale)


def unchanged(counter):
    """The wrapper ran its twin: the launch counter did not move."""
    class _Ctx:
        def __enter__(self):
            self.n = counter.launches

        def __exit__(self, *exc):
            assert counter.launches == self.n
    return _Ctx()


@pytest.mark.parametrize("ncol", [128, 136])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rescale,jac", [(False, False), (True, False),
                                         (False, True), (True, True)],
                         ids=["plain", "rescale", "jac", "rescale-jac"])
def test_lw_noscat_lanes_matches_pallas(dt, ncol, rescale, jac):
    dtype, tol = DTYPES[dt]
    u, tau = rand(dtype, 1)
    ngpt = 24
    arrays = [tau(ngpt, NLAY, ncol), u(0, 50, ngpt, NLAY, ncol),
              u(0, 50, ngpt, NLAY + 1, ncol), u(0.8, 1.0, ngpt, ncol),
              u(0, 50, ngpt, ncol), u(0, 2, ngpt, ncol),
              u(0, 0.9, ngpt, NLAY, ncol), u(0, 0.9, ngpt, NLAY, ncol),
              u(0, 5, ngpt, ncol)]
    j, t = both(arrays, dtype)
    kw = dict(ds=DS, weight=WEIGHT, do_rescaling=rescale, do_jacobians=jac)
    ref = jlanes.lw_noscat_broadband_lanes(
        *j[:6], ssa=j[6], g=j[7], sfc_src_jac=j[8], interpret=True, **kw)
    with unchanged(lw_noscat_lanes):
        got = lw_noscat_lanes(*t[:6], ssa=t[6], g=t[7], sfc_src_jac=t[8],
                              **kw)
    assert (got[2] is None) == (not jac)
    check(got, ref, tol)


@pytest.mark.parametrize("ncol", [128, 136])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cloud", [False, True], ids=["clear", "cloud"])
def test_lw_noscat_lanes_pfrac_matches_pallas(dt, ncol, cloud):
    dtype, tol = DTYPES[dt]
    u, tau = rand(dtype, 2)
    ngpt, nbnd = 32, 4
    pf = u(0.01, 0.2, ngpt, NLAY, ncol)
    pf[3, 2] = 0.0                       # a zero fraction inside
    arrays = [tau(ngpt, NLAY, ncol), pf, u(1, 80, nbnd, NLAY, ncol),
              u(1, 80, nbnd, NLAY + 1, ncol), u(1, 80, nbnd, ncol),
              u(0.8, 1.0, ngpt, ncol), u(0, 2, ngpt, ncol),
              u(0.012, 3.0, nbnd, NLAY, ncol) if cloud else None]
    j, t = both(arrays, dtype)
    ref = jlanes.lw_noscat_broadband_lanes_pfrac(
        *j[:7], ds=DS, weight=WEIGHT, band_width=ngpt // nbnd,
        cloud_tau_abs=j[7], interpret=True)
    gpt2band = torch.arange(ngpt, dtype=torch.int32) // (ngpt // nbnd)
    with unchanged(lw_noscat_lanes_pfrac):
        got = lw_noscat_lanes_pfrac(*t[:7], ds=DS, weight=WEIGHT,
                                    gpt2band=gpt2band, cloud_tau_abs=t[7])
    check(got, ref, tol)


def test_lw_pfrac_ragged_bands():
    """Bands of 3, 9, 1 and 11 g-points: the in-kernel-sources twin equals
    the plain lane twin fed with the sources and cloud formed by hand."""
    u, tau = rand(np.float64, 3)
    widths = [3, 9, 1, 11]
    ngpt, nbnd, ncol = sum(widths), len(widths), 40
    band = torch.repeat_interleave(torch.arange(nbnd), torch.tensor(widths))
    t = lambda a: torch.as_tensor(a)
    tau_, pf = t(tau(ngpt, NLAY, ncol)), t(u(0.01, 0.2, ngpt, NLAY, ncol))
    pbl, pbv = t(u(1, 80, nbnd, NLAY, ncol)), t(u(1, 80, nbnd, NLAY + 1,
                                                  ncol))
    pbs, emis = t(u(1, 80, nbnd, ncol)), t(u(0.8, 1.0, ngpt, ncol))
    inc, cld = t(u(0, 2, ngpt, ncol)), t(u(0, 3, nbnd, NLAY, ncol))
    got = lw_noscat_lanes_pfrac(tau_, pf, pbl, pbv, pbs, emis, inc, ds=DS,
                                weight=WEIGHT, gpt2band=band.int(),
                                cloud_tau_abs=cld)
    ref = lw_noscat_lanes(tau_ + cld[band], pf * pbl[band],
                          level_pfrac(pf) * pbv[band], emis,
                          pf[:, -1] * pbs[band], inc, ds=DS,
                          weight=WEIGHT)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def sw_inputs(u, tau, ngpt, ncol, dtype):
    """mu0 (nlay, ncol): night (0, negative), a low sun (1e-3, and 1e-4
    below the float32 clamp in float32 only), overhead, varying by layer;
    boundary fields (ngpt, ncol)."""
    col = np.arange(ncol)
    low = 1e-4 if dtype == np.float32 else 1e-3
    mu = np.select([col % 8 == 0, col % 8 == 1, col % 8 == 2],
                   [-0.3, 0.0, low], 0.05 + 0.95 * (col % 8) / 7.0)
    layer = np.linspace(1.0, 0.9, NLAY)[:, None]
    mu0 = np.where(mu[None, :] > 0, mu[None, :] * layer,
                   np.broadcast_to(mu, (NLAY, ncol)))
    toa = u(0.5, 5.0, ngpt, ncol)
    return [mu0, u(0, 0.3, ngpt, ncol), u(0, 0.3, ngpt, ncol), toa]


@pytest.mark.parametrize("ncol", [128, 136])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("diffuse", [False, True], ids=["dir", "dir-dif"])
def test_sw_2stream_lanes_matches_pallas(dt, ncol, diffuse):
    dtype, tol = DTYPES[dt]
    u, tau = rand(dtype, 4)
    ngpt = 24
    bounds = sw_inputs(u, tau, ngpt, ncol, dtype)
    arrays = [tau(ngpt, NLAY, ncol), u(0, 0.9, ngpt, NLAY, ncol),
              u(0, 0.9, ngpt, NLAY, ncol)] + bounds + [
        0.1 * bounds[3] if diffuse else None]
    j, t = both(arrays, dtype)
    ref = jlanes.sw_two_stream_broadband_lanes(*j, interpret=True)
    with unchanged(sw_2stream_lanes):
        got = sw_2stream_lanes(*t)
    check(got, ref, tol)
    if not diffuse:
        # the column with mu0 = 0 gets no flux at all
        assert all(float(g[:, 1].abs().max()) == 0.0 for g in got)


@pytest.mark.parametrize("ncol", [128, 136])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("cloud,diffuse", [(False, False), (True, False),
                                           (True, True)],
                         ids=["clear", "cloud", "cloud-dif"])
def test_sw_2stream_lanes_combined_matches_pallas(dt, ncol, cloud, diffuse):
    dtype, tol = DTYPES[dt]
    u, tau = rand(dtype, 5)
    ngpt, nbnd = 32, 4
    bounds = sw_inputs(u, tau, ngpt, ncol, dtype)
    ray = u(0.0, 0.3, ngpt, NLAY, ncol)
    ray[1] = 0.0
    arrays = [tau(ngpt, NLAY, ncol), ray]
    cld = ([u(0, 5, nbnd, NLAY, ncol), u(0, 0.9, nbnd, NLAY, ncol),
            u(0, 0.9, nbnd, NLAY, ncol)] if cloud else [])
    if cloud:
        cld[0][0, 1:3] = 0.0
    j, t = both(arrays + cld + bounds + [0.1 * bounds[3] if diffuse
                                         else None], dtype)
    jc = tuple(j[2:5]) if cloud else None
    tc = tuple(t[2:5]) if cloud else None
    rest = 5 if cloud else 2
    ref = jlanes.sw_two_stream_broadband_lanes_combined(
        j[0], j[1], jc, *j[rest:], band_width=ngpt // nbnd, interpret=True)
    gpt2band = torch.arange(ngpt, dtype=torch.int32) // (ngpt // nbnd)
    with unchanged(sw_2stream_lanes_combined):
        got = sw_2stream_lanes_combined(t[0], t[1], tc, *t[rest:],
                                        gpt2band=gpt2band)
    check(got, ref, tol)


def test_wrappers_refuse_other_devices():
    """Off the CPU and off CUDA (here the meta device) the wrappers raise
    instead of running anything."""
    m = lambda *s: torch.zeros(s, device="meta")
    with pytest.raises(ValueError, match="meta"):
        lw_noscat_lanes(m(4, 2, 3), m(4, 2, 3), m(4, 3, 3), m(4, 3),
                        m(4, 3), m(4, 3), ds=DS, weight=WEIGHT)
    with pytest.raises(ValueError, match="meta"):
        sw_2stream_lanes(m(4, 2, 3), m(4, 2, 3), m(4, 2, 3), m(2, 3),
                         m(4, 3), m(4, 3), m(4, 3))
