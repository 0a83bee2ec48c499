"""The port's LW true two-stream solve (rte_lw(use_2stream=True)) and the
secant handling of the no-scattering solve, against the JAX package.

  * The two-stream twins (``ops/solver_lw``: ``lw_two_stream``,
    ``lw_source_2str``, ``lw_solver_2stream``) against JAX's XLA functions
    on the same numpy-seeded float64 inputs (the 7 x 11 x 16 problem of
    tests/test_pallas_gas_optics.py:334-368), rtol 1e-10 / atol 1e-12:
    broadband, by-band and spectral output, both orientations, uniform
    and ragged bands, and tau at and around the thin-layer threshold 1e-8.
  * The kernel wrapper's twin (``ops/kernels/solver_lw_2str``, reached
    through rte_lw on CPU tensors) against JAX's Pallas kernel
    ``lw_two_stream_broadband_lane`` in interpret mode, broadband and by
    band, same bound.
  * The ported JAX tests: the purely absorbing two-stream solve
    (tests/test_lw_solver.py:132-142), the secant regressions
    (tests/test_r5_regressions.py:27-67; a 0-d tensor, a 1-D tensor and a
    tuple give the same flux, and the secant's gradient is jax.grad's
    within 1e-12 in float64) and the broadband Jacobian of a by-band solve
    (:470).
  * Gradients through the two-stream solve against jax.grad of JAX's XLA
    path, float64 (rtol 1e-9 / atol 1e-12: two autodiff systems sum the
    same terms in different orders).
  * The slice as a whole: gas_optics_lw(scattering=True) -> cloud_optics
    (scattering=True) -> increment -> rte_lw(use_2stream=True), broadband
    and by band, at the production golden shapes (256 x 72, 256 g-points
    in 16 bands), float64, against the JAX package's generic branch,
    within 1e-10 of the largest flux.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gray_atmosphere import gray_rad_equil  # noqa: E402
from rte_rrtmgp_tpu import rte_lw as jrte_lw  # noqa: E402
from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.drivers import allsky as jallsky  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.ops import solver_lw as jsolver  # noqa: E402
from rte_rrtmgp_tpu.optical_props import (  # noqa: E402
    OpticalProps2str as JProps2str, increment as jincrement)
from rte_rrtmgp_tpu.sources import SourcesLW as JSourcesLW  # noqa: E402
from rte_rrtmgp_tpu.spectral import SpectralGrid as JGrid  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics as jax_cloud, synthetic_kdist as jax_kdist)
from rte_rrtmgp_tpu_torch.drivers.allsky import build_allsky  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import lw_noscat  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (  # noqa: E402
    lw_2stream)
from rte_rrtmgp_tpu_torch.ops.solver_lw import (  # noqa: E402
    lw_solver_2stream, lw_solver_noscat, lw_source_2str, lw_two_stream)
from rte_rrtmgp_tpu_torch.optical_props import (  # noqa: E402
    OpticalProps1scl, OpticalProps2str, increment)
from rte_rrtmgp_tpu_torch.rte import rte_lw  # noqa: E402
from rte_rrtmgp_tpu_torch.sources import SourcesLW  # noqa: E402
from rte_rrtmgp_tpu_torch.spectral import SpectralGrid  # noqa: E402

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-12)
NCOL, NLAY, NGPT = 7, 11, 16
# band limits (1-based, inclusive): two uniform bands, and two ragged ones
BANDS = {"uniform": [[1, 8], [9, 16]], "ragged": [[1, 5], [6, 16]]}
WVN = [[0.0, 1500.0], [1500.0, 3250.0]]


# tau at and below the thin-layer threshold (sources exactly zero in both
# packages) and above it. Just above 1e-8 the Toon sources cancel
# catastrophically (z = dB / (tau (g1 + g2)) is about 1e9): there the two
# packages differ by rounding of pi |z| eps, up to 5e-6 W/m2 in the
# fluxes, so those values are held to that bound in the coefficient
# test only.
THIN = (0.0, 5e-9, 1e-8, 1e-5)
NEAR = (1e-8 * (1 + 1e-12), 2e-8, 1e-7)


def inputs(seed=4, thin=()):
    """numpy arrays of one two-stream problem; ``thin``: values that the
    tau of layers 2-4 takes at random."""
    rng = np.random.default_rng(seed)
    lay3 = (NCOL, NLAY, NGPT)
    a = dict(tau=rng.uniform(1e-3, 4.0, lay3), ssa=rng.uniform(0.0, 0.7, lay3),
             g=rng.uniform(0.0, 0.8, lay3), lay=rng.uniform(10, 60, lay3),
             lev=rng.uniform(10, 60, (NCOL, NLAY + 1, NGPT)),
             emis=rng.uniform(0.9, 1.0, (NCOL, NGPT)),
             sfc=rng.uniform(30, 80, (NCOL, NGPT)),
             inc=rng.uniform(0.0, 5.0, (NCOL, NGPT)))
    if thin:
        a["tau"][:, 2:5] = rng.choice(np.array(thin), (NCOL, 3, NGPT))
    return a


def both(a):
    return ({k: torch.as_tensor(v, dtype=F64) for k, v in a.items()},
            {k: jnp.asarray(v, jnp.float64) for k, v in a.items()})


def close(got, ref, **tol):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and got.dtype == F64
    np.testing.assert_allclose(got.detach().numpy(), ref, **(tol or TOL))


def group(x, gpt2band, nband):
    """Per-band sums of (..., ngpt) numpy fluxes."""
    out = np.zeros(x.shape[:-1] + (nband,))
    for g, b in enumerate(gpt2band):
        out[..., b] += x[..., g]
    return out


@pytest.mark.parametrize("thin", [(), THIN + NEAR], ids=["random", "thin"])
def test_coefficients_and_sources_match_jax(thin):
    t, j = both(inputs(thin=thin))
    got = lw_two_stream(t["tau"], t["ssa"], t["g"])
    ref = jsolver.lw_two_stream(j["tau"], j["ssa"], j["g"])
    for x, r in zip(got, ref):
        close(x, r)
    top, bot = t["lev"][:, :-1], t["lev"][:, 1:]
    src = lw_source_2str(t["emis"], t["sfc"], t["lay"], top, bot, *got,
                         t["tau"])
    jsrc = jsolver.lw_source_2str(j["emis"], j["sfc"], j["lay"],
                                  j["lev"][:, :-1], j["lev"][:, 1:], *ref,
                                  j["tau"])
    # the rounding of the Toon form's cancelling terms, pi |z| each
    z = ((bot - top) / (t["tau"] * (got[0] + got[1]))).abs()
    noise = 16 * torch.finfo(F64).eps * np.pi * (z + top.abs().max())
    for x, r in zip(src[:2], jsrc[:2]):
        err = (x - torch.as_tensor(np.asarray(r))).abs()
        assert bool((err <= 1e-12 + 1e-10 * x.abs() + noise).all())
    close(src[2], jsrc[2])
    if thin:
        # at tau <= 1e-8 both sources are zero, above it they are not
        thin_ = t["tau"] <= 1e-8
        assert bool((src[0][thin_] == 0).all() and (src[1][thin_] == 0).all())
        assert bool((src[1][~thin_] != 0).any())


@pytest.mark.parametrize("top_at_1", [True, False], ids=["top", "bottom"])
@pytest.mark.parametrize("bands", sorted(BANDS))
@pytest.mark.parametrize("output", ["broadband", "byband", "spectral"])
@pytest.mark.parametrize("thin", [(), THIN], ids=["random", "thin"])
def test_lw_solver_2stream_matches_jax_xla(output, bands, top_at_1, thin):
    a = inputs(thin=thin)
    if not top_at_1:
        for k in ("tau", "ssa", "g", "lay", "lev"):
            a[k] = a[k][:, ::-1].copy()
    t, j = both(a)
    grid = SpectralGrid.from_arrays(WVN, BANDS[bands])
    gpt2band, nband = grid.gpt2band, grid.nband
    kw = {}
    if output == "byband":
        kw = dict(gpt2band=torch.as_tensor(gpt2band, dtype=torch.int32),
                  nband=nband)
    args = lambda d: (d["tau"], d["ssa"], d["g"], d["lay"], d["lev"],
                      d["emis"], d["sfc"], d["inc"])
    n0 = lw_2stream.launches
    got = lw_solver_2stream(*args(t), top_at_1=top_at_1,
                            spectral=output == "spectral", **kw)
    assert lw_2stream.launches == n0, "a CPU tensor must not reach the kernel"
    assert got.flux_up_jac is None
    set_use_pallas(False)
    try:
        ref = jsolver.lw_solver_2stream(*args(j), top_at_1=top_at_1,
                                        spectral=output != "broadband")
    finally:
        set_use_pallas(None)
    for x, r in ((got.flux_up, ref.flux_up), (got.flux_dn, ref.flux_dn)):
        r = np.asarray(r)
        if output == "byband":
            r = group(r, gpt2band, nband)
        close(x, r)


@pytest.mark.parametrize("byband", [False, True], ids=["broadband", "byband"])
def test_rte_lw_2stream_matches_pallas_interpret(byband):
    """rte_lw(use_2stream=True) in the port (the kernel wrapper's twin on
    the CPU) against the JAX package's with its Pallas kernel
    lw_two_stream_broadband_lane in interpret mode (uniform bands, the
    kernel's by-band condition), as tests/test_pallas_gas_optics.py:
    334-368 runs it."""
    t, j = both(inputs())
    grid = SpectralGrid.from_arrays(WVN, BANDS["uniform"])
    jgrid = JGrid.from_arrays(WVN, BANDS["uniform"])
    props = OpticalProps2str(tau=t["tau"], ssa=t["ssa"], g=t["g"], grid=grid)
    src = SourcesLW(lay_source=t["lay"], lev_source=t["lev"],
                    sfc_source=t["sfc"], sfc_source_jac=0 * t["sfc"],
                    grid=grid)
    jprops = JProps2str(tau=j["tau"], ssa=j["ssa"], g=j["g"], grid=jgrid)
    jsrc = JSourcesLW(lay_source=j["lay"], lev_source=j["lev"],
                      sfc_source=j["sfc"], sfc_source_jac=0 * j["sfc"],
                      grid=jgrid)
    emis = np.random.default_rng(4).uniform(0.9, 1.0, (NCOL, 1))
    got = rte_lw(props, src, emis, inc_flux=t["inc"], use_2stream=True,
                 byband=byband)
    set_use_pallas(True)
    try:
        ref = jrte_lw(jprops, jsrc, jnp.asarray(emis), inc_flux=j["inc"],
                      use_2stream=True, byband=byband)
    finally:
        set_use_pallas(None)
    assert got.flux_up.shape == ((NCOL, NLAY + 1, 2) if byband
                                 else (NCOL, NLAY + 1))
    for n in ("flux_up", "flux_dn", "flux_net"):
        close(getattr(got, n), getattr(ref, n))


def gray():
    """The gray-equilibrium problem of tests/gray_atmosphere.py as the
    port's 1scl and zero-scattering 2str props."""
    sfc_t = np.array([285.0] * 4 + [310.0] * 4)
    jprops, jsrc = gray_rad_equil(sfc_t, np.array([0.1, 1.0, 10.0, 50.0] * 2),
                                  16)
    grid = SpectralGrid.from_arrays(np.asarray(jprops.grid.band_lims_wvn),
                                    np.asarray(jprops.grid.band_lims_gpt))
    c = lambda x: torch.as_tensor(np.array(x), dtype=F64)
    tau = c(jprops.tau)
    src = SourcesLW(lay_source=c(jsrc.lay_source),
                    lev_source=c(jsrc.lev_source),
                    sfc_source=c(jsrc.sfc_source),
                    sfc_source_jac=c(jsrc.sfc_source_jac), grid=grid)
    return (OpticalProps1scl(tau=tau, grid=grid),
            OpticalProps2str(tau=tau, ssa=0 * tau, g=0 * tau, grid=grid), src)


def test_two_stream_solver_purely_absorbing():
    """tests/test_lw_solver.py:132-142: the true two-stream solve of an
    absorption-only problem is close to the no-scattering one (1.66
    against 1/0.6096 as the diffusivity: only approximately)."""
    props, props2, src = gray()
    emis = np.ones((8, 1))
    ref = rte_lw(props, src, emis)
    f = rte_lw(props2, src, emis, use_2stream=True)
    np.testing.assert_allclose(f.flux_up[:, 0].numpy(),
                               ref.flux_up[:, 0].numpy(), rtol=5e-2)


@pytest.mark.parametrize("byband", [False, True], ids=["broadband", "byband"])
def test_two_stream_grads_match_jax(byband):
    """d loss / d (tau, ssa, g, lev, emis, sfc, inc) of the two-stream
    solve (the kernel wrapper's with_twin_grad on the CPU) against
    jax.grad of JAX's XLA lw_solver_2stream."""
    # layers at and below the threshold only: just above it the tau
    # cotangent is as ill-conditioned as the sources (1e-5 relative at
    # tau = 1e-5)
    a = inputs(thin=THIN[:3])
    grid = SpectralGrid.from_arrays(WVN, BANDS["uniform"])
    kw = (dict(gpt2band=torch.as_tensor(grid.gpt2band, dtype=torch.int32),
               nband=grid.nband) if byband else {})
    w = np.random.default_rng(9).uniform(0.5, 1.5, (NLAY + 1,)
                                         + ((2,) if byband else ()))
    names = ("tau", "ssa", "g", "lev", "emis", "sfc", "inc")
    lay = torch.as_tensor(a["lay"])
    leaves = [torch.tensor(a[k], requires_grad=True) for k in names]
    tau, ssa, g, lev, emis, sfc, inc = leaves
    f = lw_solver_2stream(tau, ssa, g, lay, lev, emis, sfc, inc,
                          top_at_1=True, **kw)
    wt = torch.as_tensor(w)
    loss = (wt * f.flux_up).sum() + 0.5 * (wt * f.flux_dn).sum()
    got = torch.autograd.grad(loss, leaves)

    def jloss(tau, ssa, g, lev, emis, sfc, inc):
        set_use_pallas(False)
        try:
            r = jsolver.lw_solver_2stream(
                tau, ssa, g, jnp.asarray(a["lay"]), lev, emis, sfc, inc,
                top_at_1=True, byband_width=8 if byband else None)
        finally:
            set_use_pallas(None)
        return jnp.sum(w * r.flux_up) + 0.5 * jnp.sum(w * r.flux_dn)

    ref = jax.grad(jloss, argnums=tuple(range(7)))(
        *(jnp.asarray(a[k]) for k in names))
    for n, x, r in zip(names, got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-12, err_msg=n)
    assert all(bool((x != 0).any()) for x in got)


def r5_problem(seed=3):
    """tests/test_r5_regressions.py::_lw_problem, in float64."""
    rng = np.random.default_rng(seed)
    ncol, nlay, ngpt = 4, 6, 16
    return dict(tau=rng.uniform(0.05, 2.0, (ncol, nlay, ngpt)),
                lay=rng.uniform(5.0, 20.0, (ncol, nlay, ngpt)),
                lev=rng.uniform(5.0, 20.0, (ncol, nlay + 1, ngpt)),
                emis=np.full((ncol, ngpt), 0.95),
                ssrc=rng.uniform(10.0, 30.0, (ncol, ngpt)),
                inc=np.zeros((ncol, ngpt)))


def _r5_args(d):
    return (d["tau"], d["lay"], d["lev"], d["emis"], d["ssrc"], d["inc"])


def test_grad_wrt_traced_secant():
    """tests/test_r5_regressions.py:27-48: the gradient with respect to a
    secant passed as a 0-d tensor that requires grad (a traced scalar in
    the JAX package) takes the twin's gradient: jax.grad's within 1e-12,
    and a central difference's within 5e-2, float64."""
    t, j = both(r5_problem())
    n0 = lw_noscat.launches
    ds = torch.tensor(1.66, dtype=F64, requires_grad=True)
    f = lw_solver_noscat(*_r5_args(t), top_at_1=True, ds=(ds,),
                         weights=(0.5,))
    g, = torch.autograd.grad(f.flux_up.sum(), ds)
    assert lw_noscat.launches == n0

    def loss(d):
        set_use_pallas(False)
        try:
            r = jsolver.lw_solver_noscat(*_r5_args(j), top_at_1=True,
                                         ds=(d,), weights=(0.5,))
        finally:
            set_use_pallas(None)
        return jnp.sum(r.flux_up)

    ref = float(jax.grad(loss)(jnp.float64(1.66)))
    assert np.isfinite(float(g)) and float(g) != 0.0
    np.testing.assert_allclose(float(g), ref, rtol=1e-12)
    eps = 1e-2
    fd = lambda d: float(lw_solver_noscat(
        *_r5_args(t), top_at_1=True, ds=(d,), weights=(0.5,)).flux_up.sum())
    np.testing.assert_allclose(float(g), (fd(1.66 + eps) - fd(1.66 - eps))
                               / (2 * eps), rtol=5e-2)


def test_concrete_array_secant_matches_tuple():
    """tests/test_r5_regressions.py:51-67: a tuple of floats, a tuple of
    0-d tensors, a 1-D tensor and a bare 0-d tensor give bit-identical
    fluxes, equal to the JAX package's within 1e-12."""
    t, j = both(r5_problem(seed=5))
    kw = dict(top_at_1=True, weights=(0.5,))
    cases = ((1.66,), (torch.tensor(1.66, dtype=F64),),
             torch.tensor([1.66], dtype=F64), torch.tensor(1.66, dtype=F64))
    fluxes = [lw_solver_noscat(*_r5_args(t), ds=d, **kw) for d in cases]
    for f in fluxes[1:]:
        assert torch.equal(f.flux_up, fluxes[0].flux_up)
        assert torch.equal(f.flux_dn, fluxes[0].flux_dn)
    set_use_pallas(False)
    try:
        ref = jsolver.lw_solver_noscat(*_r5_args(j),
                                       ds=jnp.asarray([1.66]), **kw)
    finally:
        set_use_pallas(None)
    close(fluxes[0].flux_up, ref.flux_up, rtol=1e-12, atol=0)
    close(fluxes[0].flux_dn, ref.flux_dn, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="secants for"):
        lw_solver_noscat(*_r5_args(t), ds=torch.tensor([1.6, 1.7]), **kw)
    with pytest.raises(ValueError, match="a secant of shape"):
        lw_solver_noscat(*_r5_args(t), ds=(torch.ones(3, 5),), **kw)


def test_byband_jacobian_broadband():
    """tests/test_r5_regressions.py:470: rte_lw(byband=True,
    compute_jacobian=True) gives per-band fluxes and the broadband
    Jacobian, on contiguous bands and on the same bands listed in another
    order (the ragged route in the JAX package); the port's fluxes and
    Jacobian equal the JAX package's."""
    rng = np.random.default_rng(2)
    ncol, nlay, ngpt = 4, 6, 8
    a = dict(tau=rng.uniform(0.1, 2.0, (ncol, nlay, ngpt)),
             lay=rng.uniform(5, 20, (ncol, nlay, ngpt)),
             lev=rng.uniform(5, 20, (ncol, nlay + 1, ngpt)),
             sfc=rng.uniform(10, 30, (ncol, ngpt)),
             jac=rng.uniform(0.1, 1, (ncol, ngpt)))
    t, j = both(a)
    out = []
    for wvn, gpt in (([[10.0, 500.0], [500.0, 3000.0]], [[1, 4], [5, 8]]),
                     ([[500.0, 3000.0], [10.0, 500.0]], [[5, 8], [1, 4]])):
        grid, jgrid = SpectralGrid.from_arrays(wvn, gpt), JGrid.from_arrays(
            wvn, gpt)
        f = rte_lw(OpticalProps1scl(tau=t["tau"], grid=grid),
                   SourcesLW(lay_source=t["lay"], lev_source=t["lev"],
                             sfc_source=t["sfc"], sfc_source_jac=t["jac"],
                             grid=grid), np.ones((ncol, 1)),
                   compute_jacobian=True, byband=True)
        from rte_rrtmgp_tpu import OpticalProps1scl as J1scl
        set_use_pallas(False)
        try:
            r = jrte_lw(J1scl(tau=j["tau"], grid=jgrid),
                        JSourcesLW(lay_source=j["lay"], lev_source=j["lev"],
                                   sfc_source=j["sfc"],
                                   sfc_source_jac=j["jac"], grid=jgrid),
                        jnp.ones((ncol, 1)), compute_jacobian=True,
                        byband=True)
        finally:
            set_use_pallas(None)
        assert f.flux_up.shape == (ncol, nlay + 1, 2)
        assert f.flux_up_jac.shape == (ncol, nlay + 1)
        for n in ("flux_up", "flux_dn", "flux_up_jac"):
            close(getattr(f, n), getattr(r, n))
        out.append(f)
    np.testing.assert_allclose(out[1].flux_up_jac.numpy(),
                               out[0].flux_up_jac.numpy(), rtol=1e-12)


PRODUCTION = (256, 72, 256, 16, 224, 14, 14, 59)


@pytest.fixture(scope="module")
def production():
    """The port's production problem (float64, CPU) and the JAX package's
    objects from the same seeds."""
    ncol, nlay, ngl, nbl, _, _, ntemp, npres = PRODUCTION
    p = build_allsky(*PRODUCTION, device="cpu", dtype=F64)
    kd = jax_kdist(sw=False, ngpt=ngl, nbnd=nbl, ntemp=ntemp, npres=npres,
                   dtype=jnp.float64)
    cld = jax_cloud(nbnd=nbl, band_lims_wvn=kd.grid.band_lims_wvn_array,
                    dtype=jnp.float64)
    inp = jallsky.make_allsky_inputs(ncol, nlay, cloud_optics=cld,
                                     dtype=jnp.float64)
    return p, JGasOptics(kd), cld, inp


@pytest.mark.parametrize("byband", [False, True], ids=["broadband", "byband"])
def test_lw_scattering_path_matches_jax(production, byband):
    """The slice's path, reference check_variants' true two-stream with
    clouds (examples/flux_variants.py:76-82): gas optics with scattering,
    the 2-stream cloud optics, increment, rte_lw(use_2stream=True)."""
    p, jgas, jcld, jinp = production
    i = p.inputs
    props, src = p.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                        i.gas_concs, tlev=i.tlev,
                                        scattering=True, top_at_1=True)
    props = increment(props, p.cld_lw.cloud_optics(i.lwp, i.iwp, i.rel,
                                                   i.dei, scattering=True))
    assert isinstance(props, OpticalProps2str)
    got = rte_lw(props, src, i.sfc_emis, use_2stream=True, byband=byband)
    set_use_pallas(False)
    try:
        jprops, jsrc = jgas.gas_optics_lw(
            jinp.play, jinp.plev, jinp.tlay, jinp.tsfc, jinp.gas_concs,
            tlev=jinp.tlev, scattering=True, top_at_1=True)
        jprops = jincrement(jprops, jcld.cloud_optics(
            jinp.lwp, jinp.iwp, jinp.rel, jinp.dei, scattering=True))
        ref = jrte_lw(jprops, jsrc, jinp.sfc_emis, use_2stream=True,
                      byband=byband)
    finally:
        set_use_pallas(None)
    for n in ("flux_up", "flux_dn", "flux_net"):
        r = np.asarray(getattr(ref, n))
        close(getattr(got, n), r, rtol=0, atol=1e-10 * np.abs(r).max())
    up = got.flux_up
    assert bool(torch.isfinite(up).all()) and bool((up >= 0).all())
