"""Gradients through the port against jax.grad of the JAX package (CPU).

The shapes of tests/test_fused_autodiff.py: 8 columns x 8 layers, 32
g-points in 4 bands, ntemp 5, npres 10, float64, the same numpy-seeded
inputs given to both packages (convert.py carries the tables across). On
the CPU every kernel wrapper runs its plain twin, and each
torch.autograd.Function's backward is the twin's autograd recomputed
from the saved inputs; the JAX side is its pure-XLA reference
(set_use_pallas(False)). Bounds are the JAX package's own for its fused
adjoints at float64 (tests/test_fused_autodiff.py:620, :717): LW rtol
1e-8 / atol 1e-12, SW rtol 1e-7 / atol 1e-11.

  * the fused LW and SW steps with respect to play, plev, tlay, tlev,
    tsfc, two gas amounts, the cloud, the emissivity, mu0 and the albedo
    (one albedo tensor passed twice);
  * the all-sky driver, fused and through the public API, with respect
    to tlay, the liquid water path and the droplet size, with aerosols
    off and on; clear sky;
  * each Function against the plain twin's own autograd on the same
    leaves (rtol 1e-12: the wiring, not the arithmetic, is under test),
    with permuted and expanded views among the inputs and integer inputs
    that get no gradient; two backward calls give the same bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import (  # noqa: E402
    set_fused_adjoint, set_use_pallas)
from rte_rrtmgp_tpu.drivers import allsky as jallsky  # noqa: E402
from rte_rrtmgp_tpu.gas_concs import GasConcs as JGasConcs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_aerosol_optics as jax_aerosol, synthetic_cloud_optics as
    jax_cloud, synthetic_kdist as jax_kdist)
from rte_rrtmgp_tpu_torch.convert import kdist_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_lw_inputs, allsky_step_lw,
    allsky_step_sw, allsky_sw_inputs, build_allsky, make_allsky_inputs)
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP, _major, _minor, _rayleigh)
from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.autodiff import (  # noqa: E402
    refuse_grad, with_twin_grad)
from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (  # noqa: E402
    cloud_props, cloud_props_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    lw_fused, lw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused, sw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (  # noqa: E402
    gas_major_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (  # noqa: E402
    rayleigh_combine)
from rte_rrtmgp_tpu_torch.ops.gas_optics import tau_minor  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import (  # noqa: E402
    lw_noscat, lw_noscat_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_bwd import (  # noqa: E402
    lw_noscat_vjp)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import (  # noqa: E402
    sw_2stream_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw_bwd import (  # noqa: E402
    sw_2stream_vjp)
from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS  # noqa: E402

F64 = torch.float64
NCOL, NLAY, NGPT, NBND = 8, 8, 32, 4
SIZES = dict(ngpt=NGPT, nbnd=NBND, ntemp=5, npres=10)
DIMS = (NCOL, NLAY, NGPT, NBND, NGPT, NBND, 5, 10)
DS, WT = GAUSS_DS[0][0], GAUSS_WTS[0][0]
LW_TOL = dict(rtol=1e-8, atol=1e-12)
SW_TOL = dict(rtol=1e-7, atol=1e-11)


def atmosphere(seed=7):
    """numpy arrays of one perturbed all-sky atmosphere and its gases."""
    rng = np.random.default_rng(seed)
    inp = make_allsky_inputs(NCOL, NLAY, dtype=F64, device="cpu")
    a = {k: getattr(inp, k).numpy().copy()
         for k in ("play", "plev", "tlay", "tlev")}
    a["tlay"] += rng.uniform(-5.0, 5.0, a["tlay"].shape)
    a["tsfc"] = rng.uniform(280.0, 310.0, NCOL)
    gases = {g: inp.gas_concs.get_vmr(g, NCOL, NLAY).numpy().copy()
             for g in inp.gas_concs.names}
    a["h2o"], a["o3"] = gases["h2o"], gases["o3"]
    return a, gases, rng


def _gc(cls, gases, **override):
    gc = cls.empty()
    for k, v in gases.items():
        gc = gc.set_vmr(k, override.get(k, v))
    return gc


def port_grads(loss, arrays):
    leaves = {k: torch.tensor(v, dtype=F64, requires_grad=True)
              for k, v in arrays.items()}
    out = loss(**leaves)
    got = torch.autograd.grad(out, list(leaves.values()), allow_unused=True)
    return dict(zip(leaves, got))


def jax_grads(loss, arrays):
    names = list(arrays)
    vals = [jnp.asarray(arrays[k], jnp.float64) for k in names]
    got = jax.grad(lambda *a: loss(**dict(zip(names, a))),
                   argnums=tuple(range(len(names))))(*vals)
    return {k: np.asarray(g) for k, g in zip(names, got)}


def assert_grads(got, ref, tol, min_nonzero):
    nonzero = 0
    for k, r in ref.items():
        g = got[k]
        assert g is not None, f"no gradient for {k}"
        np.testing.assert_allclose(g.numpy(), r, err_msg=k, **tol)
        nonzero += bool(np.any(r != 0.0))
    assert nonzero >= min_nonzero


def jax_pallas(kernel):
    """The JAX package's XLA path, or with ``kernel`` its Pallas kernels
    (in interpret mode on the CPU) with the fused adjoint kernels."""
    set_use_pallas(kernel)
    set_fused_adjoint(True if kernel else None)

    def done():
        set_use_pallas(None)
        set_fused_adjoint(None)
    return done


@pytest.fixture(scope="module")
def gases_lw():
    jkd = jax_kdist(sw=False, dtype=jnp.float64, **SIZES)
    return JGasOptics(jkd), GasOpticsRRTMGP(kdist_from_jax(
        jkd, dtype=F64, device="cpu"))


@pytest.fixture(scope="module")
def gases_sw():
    jkd = jax_kdist(sw=True, dtype=jnp.float64, **SIZES)
    return JGasOptics(jkd), GasOpticsRRTMGP(kdist_from_jax(
        jkd, dtype=F64, device="cpu"))


def lw_fused_case(gases_lw, jax_kernel=False):
    """(arrays, port loss, JAX loss) of the fused LW step: the JAX loss
    through the XLA reference, or with ``jax_kernel`` through the fused
    Pallas kernel and its adjoint kernel."""
    jgas, gas = gases_lw
    a, gases, rng = atmosphere()
    a["emis"] = rng.uniform(0.8, 1.0, (NGPT, NCOL))
    a["cld"] = np.where(rng.uniform(size=(NBND, NLAY, NCOL)) < 0.5, 0.0,
                        rng.uniform(0.0, 3.0, (NBND, NLAY, NCOL)))
    w_t = torch.linspace(0.5, 1.5, NLAY + 1, dtype=F64)[:, None]
    w_j = jnp.linspace(0.5, 1.5, NLAY + 1)[:, None]

    def port(play, plev, tlay, tlev, tsfc, h2o, o3, emis, cld):
        up, dn = gas.lw_fused_solve(
            play, plev, tlay, tsfc, _gc(GasConcs, gases, h2o=h2o, o3=o3),
            sfc_emis=emis, tlev=tlev, cloud_tau_abs=cld, ds=DS, weight=WT)
        return (w_t * up).sum() + 0.5 * (w_t * dn).sum()

    def ref(play, plev, tlay, tlev, tsfc, h2o, o3, emis, cld):
        gc = _gc(JGasConcs, gases, h2o=h2o, o3=o3)
        done = jax_pallas(jax_kernel)
        try:
            if jax_kernel:
                up, dn = jgas.lw_fused_solve(
                    play, plev, tlay, tsfc, gc, sfc_emis=emis, tlev=tlev,
                    cloud_tau_abs=cld, ds=DS, weight=WT)
            else:
                up, dn = jgas._lw_fused_xla_ref(
                    play, plev, tlay, tsfc, gc, emis,
                    jnp.zeros((NGPT, NCOL)), tlev, None, cld, ds=DS,
                    weight=WT, byband=False)
        finally:
            done()
        return jnp.sum(w_j * up) + 0.5 * jnp.sum(w_j * dn)

    return a, port, ref


def sw_fused_case(gases_sw, jax_kernel=False):
    """(arrays, port loss, JAX loss) of the fused SW step, as
    :func:`lw_fused_case`; one albedo tensor serves as both albedos."""
    jgas, gas = gases_sw
    a, gases, rng = atmosphere(11)
    del a["tlev"], a["tsfc"]
    a["mu0"] = (rng.uniform(0.2, 1.0, NCOL)[None, :]
                * np.linspace(1.0, 0.97, NLAY)[:, None])
    a["alb"] = rng.uniform(0.05, 0.4, (NGPT, NCOL))
    cut = rng.uniform(size=(NBND, NLAY, NCOL)) < 0.5
    a["ct"] = np.where(cut, 0.0, rng.uniform(0.0, 2.0, (NBND, NLAY, NCOL)))
    a["cs"] = rng.uniform(0.3, 0.99, (NBND, NLAY, NCOL))
    a["cg"] = rng.uniform(0.1, 0.9, (NBND, NLAY, NCOL))
    inc = np.broadcast_to(np.asarray(jgas.kdist.solar_source)[:, None],
                          (NGPT, NCOL))
    w_t = torch.linspace(0.5, 1.5, NLAY + 1, dtype=F64)[:, None]
    w_j = jnp.linspace(0.5, 1.5, NLAY + 1)[:, None]

    def port(play, plev, tlay, h2o, o3, mu0, alb, ct, cs, cg):
        up, dn, fdir = gas.sw_fused_solve(
            play, plev, tlay, _gc(GasConcs, gases, h2o=h2o, o3=o3), mu0=mu0,
            sfc_alb_dir=alb, sfc_alb_dif=alb, cloud=(ct, cs, cg))
        return ((w_t * up).sum() + 0.5 * (w_t * dn).sum()
                + 0.25 * fdir.sum())

    def ref(play, plev, tlay, h2o, o3, mu0, alb, ct, cs, cg):
        gc = _gc(JGasConcs, gases, h2o=h2o, o3=o3)
        done = jax_pallas(jax_kernel)
        try:
            if jax_kernel:
                up, dn, fdir = jgas.sw_fused_solve(
                    play, plev, tlay, gc, mu0=mu0, sfc_alb_dir=alb,
                    sfc_alb_dif=alb, cloud=(ct, cs, cg))
            else:
                up, dn, fdir = jgas._sw_fused_xla_ref(
                    play, plev, tlay, gc, mu0, alb, alb, jnp.asarray(inc),
                    None, None, (ct, cs, cg), byband=False)
        finally:
            done()
        return (jnp.sum(w_j * up) + 0.5 * jnp.sum(w_j * dn)
                + 0.25 * jnp.sum(fdir))

    return a, port, ref


def test_lw_fused_grads_match_jax(gases_lw):
    a, port, ref = lw_fused_case(gases_lw)
    assert_grads(port_grads(port, a), jax_grads(ref, a), LW_TOL, 8)


def test_sw_fused_grads_match_jax(gases_sw):
    a, port, ref = sw_fused_case(gases_sw)
    assert_grads(port_grads(port, a), jax_grads(ref, a), SW_TOL, 9)


@pytest.fixture(scope="module")
def problems():
    """The port's all-sky problems (aerosols on and off) and the JAX
    package's objects built from the same seeds."""
    kw = dict(dtype=jnp.float64, **SIZES)
    kd_lw, kd_sw = jax_kdist(sw=False, **kw), jax_kdist(sw=True, **kw)
    per = lambda make, kd: make(nbnd=NBND,
                                band_lims_wvn=kd.grid.band_lims_wvn_array,
                                dtype=jnp.float64)
    jax_objs = dict(gas_lw=JGasOptics(kd_lw), gas_sw=JGasOptics(kd_sw),
                    cld_lw=per(jax_cloud, kd_lw), cld_sw=per(jax_cloud, kd_sw),
                    aer_lw=per(jax_aerosol, kd_lw),
                    aer_sw=per(jax_aerosol, kd_sw))
    jinp = jallsky.make_allsky_inputs(NCOL, NLAY, cloud_optics=jax_objs[
        "cld_lw"], dtype=jnp.float64)
    port = build_allsky(*DIMS, device="cpu", dtype=F64, use_aerosols=True)
    return port, jax_objs, jinp


DRIVER_CASES = {
    "fused": (allsky_step_lw, allsky_step_sw, {}),
    "fused-aerosols": (allsky_step_lw, allsky_step_sw,
                       dict(use_aerosols=True)),
    "fused-clear": (allsky_step_lw, allsky_step_sw, dict(use_clouds=False)),
    "api": (allsky_api_lw, allsky_api_sw, {}),
    "api-aerosols": (allsky_api_lw, allsky_api_sw, dict(use_aerosols=True)),
}


@pytest.mark.parametrize("band", ["lw", "sw"])
@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_grads_match_jax(problems, case, band):
    """d sum(flux_net) / d (tlay, lwp, rel) through the port's all-sky
    step (the fused branch, or the public API) against jax.grad of the
    JAX driver's XLA branch on the same inputs."""
    p, j, jinp = problems
    lw_fn, sw_fn, opts = DRIVER_CASES[case]
    port_fn = lw_fn if band == "lw" else sw_fn
    jax_fn = jallsky.allsky_step_lw if band == "lw" else jallsky.allsky_step_sw
    gas, cld, aer = ((p.gas_lw, p.cld_lw, p.aer_lw) if band == "lw"
                     else (p.gas_sw, p.cld_sw, p.aer_sw))
    jgas, jcld, jaer = (j[f"gas_{band}"], j[f"cld_{band}"], j[f"aer_{band}"])
    a = {k: getattr(p.inputs, k).numpy() for k in ("tlay", "lwp", "rel")}

    def port(tlay, lwp, rel):
        f = port_fn(p.inputs._replace(tlay=tlay, lwp=lwp, rel=rel), gas,
                    cloud_optics=cld, aerosol_optics=aer, **opts)
        return f.flux_net.sum()

    def ref(tlay, lwp, rel):
        done = jax_pallas(False)
        try:
            f = jax_fn(jinp._replace(tlay=tlay, lwp=lwp, rel=rel), jgas,
                       cloud_optics=jcld, aerosol_optics=jaer, **opts)
        finally:
            done()
        return jnp.sum(f.flux_net)

    got, want = port_grads(port, a), jax_grads(ref, a)
    clouds = opts.get("use_clouds", True)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        g = got[k]          # None where the loss does not reach the input
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-12 + 1e-12 * scale, err_msg=k)
        assert np.isfinite(w).all()
    assert np.any(want["tlay"] != 0.0)
    assert bool(np.any(want["lwp"] != 0.0)) == clouds


def test_lw_fused_tsfc_grad_matches_analytic_jacobian(gases_lw):
    """d(sum of TOA flux_up)/d(tsfc) through the fused step against the
    solver's transported surface Jacobian (the reference's 1 K difference
    of the Planck function: rtol 2e-2, as tests/test_fused_autodiff.py:
    148), both positive."""
    from rte_rrtmgp_tpu_torch.ops.solver_lw import lw_solver_noscat
    _, gas = gases_lw
    a, gases, _ = atmosphere()
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in a.items()}
    gc = _gc(GasConcs, gases)
    emis = torch.full((NGPT, NCOL), 0.98, dtype=F64)
    tsfc = t["tsfc"].clone().requires_grad_()
    up, _ = gas.lw_fused_solve(t["play"], t["plev"], t["tlay"], tsfc, gc,
                               sfc_emis=emis, tlev=t["tlev"], ds=DS,
                               weight=WT)
    grad, = torch.autograd.grad(up[0].sum(), tsfc)
    props, src = gas.gas_optics_lw(t["play"], t["plev"], t["tlay"],
                                   t["tsfc"], gc, tlev=t["tlev"],
                                   top_at_1=True)
    f = lw_solver_noscat(props.tau, src.lay_source, src.lev_source, emis.T,
                         src.sfc_source, torch.zeros_like(src.sfc_source),
                         top_at_1=True, ds=(DS,), weights=(WT,),
                         sfc_src_jac=src.sfc_source_jac, do_jacobians=True)
    jac = f.flux_up_jac[:, 0]
    assert bool((jac > 0).all())
    np.testing.assert_allclose(grad.numpy(), jac.numpy(), rtol=2e-2)


# ---------------------------------------------------------------------------
# each Function against the plain twin's own autograd (the wiring)
# ---------------------------------------------------------------------------

def _descriptors(p, gas):
    i = p.inputs
    cg, dry, h2o = gas.col_gas(i.play, i.plev, i.gas_concs)
    return gas.interp(i.play, i.tlay, cg), cg, dry, h2o


class View:
    """An input given to both paths as a view (``fn``) of a leaf
    (``base``)."""
    def __init__(self, base, fn):
        self.base, self.fn = base, fn


def function_cases(p, rng):
    """name -> (function path, plain path, inputs): both paths take the
    same inputs and return a tensor or a tuple of them."""
    i = p.inputs
    g = lambda *s: torch.as_tensor(rng.uniform(0.1, 1.0, s), dtype=F64)
    cases = {}
    idx, fint, wp = p.cld_lw.lane_inputs(i.lwp, i.iwp, i.rel, i.dei)
    liq, ice = p.cld_lw.tables()
    # the water path as a permuted view of a (ncol, nlay, 2) leaf
    wp_view = View(wp.permute(2, 1, 0).contiguous(),
                   lambda x: x.permute(2, 1, 0))
    cases["cloud_props"] = (
        lambda *a: with_twin_grad(cloud_props, cloud_props_plain, *a),
        cloud_props_plain, (idx, fint, wp_view, liq, ice))
    gas = p.gas_lw
    co, cg, dry, h2o = _descriptors(p, gas)
    kd = gas.kdist
    cases["gas_major"] = (_major, gas_major_plain,
                          (co, kd.kmajor, kd.planck_frac, gas.gpoint_flavor))
    tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
    nlo = len(kd.minor_lower)
    minors = tuple(m[1:] for m in gas.minors if m[0])
    sc = minor_scaling(co, kd.minor_lower, lower=True, play=i.play,
                       tlay=i.tlay, col_gas=cg, idx_h2o=h2o)
    cases["gas_minor"] = (
        _minor, lambda t, c, k, m, _, s: tau_minor(
            t.movedim(-1, 0), c, k, m, s).movedim(0, -1),
        (tau, co, kd.kminor_lower, minors, gas.minor_meta[:nlo], sc))
    gs_ = p.gas_sw
    co_s, cg_s, dry_s, h2o_s = _descriptors(p, gs_)
    tau_s = gas_major_plain(co_s, gs_.kdist.kmajor, None,
                            gs_.gpoint_flavor)[0]
    cases["gas_rayleigh"] = (
        lambda *a: _rayleigh(*a, True),
        lambda *a: rayleigh_combine(*a, scattering=True),
        (tau_s, co_s, gs_.kdist.krayl, gs_.gpoint_flavor, cg_s[h2o_s] + dry_s))
    nlev = NLAY + 1
    # tau given as a permuted view, the emissivity as an expanded one
    lw_args = (View(g(NGPT, NLAY, NCOL), lambda x: x.permute(2, 1, 0)),
               g(NCOL, NLAY, NGPT), g(NCOL, nlev, NGPT),
               View(g(NCOL, 1), lambda x: x.expand(NCOL, NGPT)),
               g(NCOL, NGPT), g(NCOL, NGPT))
    cases["lw_noscat_vjp"] = (
        lambda *a: lw_noscat_vjp(*a, ds=1.66, weight=0.5),
        lambda *a: lw_noscat_plain(*a, ds=1.66, weight=0.5)[:2], lw_args)
    cases["lw_noscat_twin"] = (
        lambda *a: with_twin_grad(
            lambda *b: lw_noscat(*b[:6], ds=b[6], weight=0.5, ssa=b[7],
                                 g=b[8]),
            lambda *b: lw_noscat_plain(*b[:6], ds=b[6], weight=0.5, ssa=b[7],
                                       g=b[8]), *a)[:2],
        lambda *a: lw_noscat_plain(*a[:6], ds=a[6], weight=0.5, ssa=a[7],
                                   g=a[8])[:2],
        lw_args + (1.0 + g(NCOL, NGPT), 0.5 * g(NCOL, NLAY, NGPT),
                   0.8 * g(NCOL, NLAY, NGPT)))
    mu0 = View(g(NCOL, 1), lambda x: x.expand(NCOL, NLAY))
    cases["sw_2stream_vjp"] = (
        sw_2stream_vjp, sw_2stream_plain,
        (g(NCOL, NLAY, NGPT), 0.9 * g(NCOL, NLAY, NGPT),
         0.8 * g(NCOL, NLAY, NGPT), mu0, 0.3 * g(NCOL, NGPT),
         0.3 * g(NCOL, NGPT), g(NCOL, NGPT), 0.1 * g(NCOL, NGPT)))
    x = allsky_lw_inputs(i, p.gas_lw, cloud_optics=p.cld_lw)
    cases["lw_fused"] = (lw_fused, lw_fused_plain, (x,))
    x = allsky_sw_inputs(i, p.gas_sw, cloud_optics=p.cld_sw)
    cases["sw_fused"] = (sw_fused, sw_fused_plain, (x,))
    return cases


FUNCTIONS = ("cloud_props", "gas_major", "gas_minor", "gas_rayleigh",
             "lw_noscat_vjp", "lw_noscat_twin", "sw_2stream_vjp", "lw_fused",
             "sw_fused")


def _leaves(args):
    """Float tensors of a nested structure as fresh leaves that require
    grad (views kept as views of their leaf), the rest as they are."""
    leaves = []

    def walk(x):
        if isinstance(x, View):
            return x.fn(walk(x.base))
        if isinstance(x, torch.Tensor):
            if not x.is_floating_point():
                return x
            base = x.detach().clone().requires_grad_()
            leaves.append(base)
            return base
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return x
    return walk(args), leaves


def _grads(fn, args):
    built, leaves = _leaves(args)
    out = fn(*built)
    outs = [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]
    loss = sum((o * torch.linspace(0.5, 1.5, o.numel(), dtype=o.dtype)
                .view(o.shape)).sum() for o in outs)
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.fixture(scope="module")
def small():
    return build_allsky(*DIMS, device="cpu", dtype=F64)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_grads_match_twin_autograd(small, name):
    """Each Function's gradient equals the plain twin's own autograd on
    the same leaves: the saved inputs, the order of the returned
    gradients, None for integer inputs, views and repeated tensors."""
    fn, plain, args = function_cases(small, np.random.default_rng(3))[name]
    got = _grads(fn, args)
    want = _grads(plain, args)
    assert len(got) == len(want)
    moved = 0
    for k, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), k
        if b is None:
            continue
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale, (name, k)
        moved += scale > 0
    assert moved >= 1


def test_backward_is_deterministic(small):
    """Two backward calls on the same inputs give the same bits."""
    x = allsky_sw_inputs(small.inputs, small.gas_sw,
                         cloud_optics=small.cld_sw)
    a = _grads(sw_fused, (x,))
    b = _grads(sw_fused, (x,))
    assert all(torch.equal(u, v) for u, v in zip(a, b) if u is not None)


def test_refuse_grad():
    """The raw wrappers' guard: raises on an input that requires grad
    with grad mode on (nested in tuples too), not under no_grad."""
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        refuse_grad("kernel", (torch.ones(2), (t,)))
    with torch.no_grad():
        refuse_grad("kernel", (t,))
    refuse_grad("kernel", torch.ones(3), None, 1.5)
