"""Gradients of the port's solvers and fused steps against the JAX
package's adjoint kernels and its XLA reference (CPU, float64).

  * The fused LW and SW steps against the JAX package's fused adjoint
    kernels run as its own tests run them on the CPU (the Pallas kernels
    in interpret mode, set_use_pallas(True), set_fused_adjoint(True); as
    tests/test_fused_autodiff.py:591-719), at its bounds (LW rtol 1e-8 /
    atol 1e-12, SW rtol 1e-7 / atol 1e-11).
  * The public solvers (lw_solver_noscat: one angle, Tang rescaling, the
    surface Jacobian, three angles, per-(column, g-point) secants;
    sw_solver_2stream with a diffuse incident flux) against jax.grad of
    the JAX package's XLA solvers (tests/test_fused_autodiff.py:238-370),
    rtol 1e-9 / atol 1e-12: the same arithmetic.
  * The SW edges of tests/test_r5_regressions.py:145-223: tau 1e-8 and
    80, a night column and the terminator. In float64 against jax.grad of
    the XLA solver (rtol 1e-7 / atol 1e-11); in float32 the port's
    gradients are finite and the night column's tau gradient is zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.ops.solver_lw import (  # noqa: E402
    lw_solver_noscat as jax_lw_solver)
from rte_rrtmgp_tpu.ops.solver_sw import (  # noqa: E402
    sw_solver_2stream as jax_sw_solver)
from rte_rrtmgp_tpu_torch.ops.solver_lw import (  # noqa: E402
    GAUSS_DS, GAUSS_WTS, lw_solver_noscat)
from rte_rrtmgp_tpu_torch.ops.solver_sw import sw_solver_2stream  # noqa: E402
from test_torch_autodiff import (  # noqa: E402
    LW_TOL, SW_TOL, assert_grads, gases_lw, gases_sw, jax_grads, jax_pallas,
    lw_fused_case, port_grads, sw_fused_case)

__all__ = ["gases_lw", "gases_sw"]      # module-scoped fixtures, reused
SOLVER_TOL = dict(rtol=1e-9, atol=1e-12)


def test_lw_fused_grads_match_jax_adjoint_kernel(gases_lw):
    a, port, ref = lw_fused_case(gases_lw, jax_kernel=True)
    assert_grads(port_grads(port, a), jax_grads(ref, a), LW_TOL, 8)


def test_sw_fused_grads_match_jax_adjoint_kernel(gases_sw):
    a, port, ref = sw_fused_case(gases_sw, jax_kernel=True)
    assert_grads(port_grads(port, a), jax_grads(ref, a), SW_TOL, 9)


def lw_solver_problem(rng, ncol=4, nlay=6, ngpt=16):
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    return dict(tau=u(0.01, 3.0, ncol, nlay, ngpt),
                lay=u(5.0, 20.0, ncol, nlay, ngpt),
                lev=u(5.0, 20.0, ncol, nlay + 1, ngpt),
                emis=u(0.8, 1.0, ncol, ngpt), ssrc=u(10.0, 30.0, ncol, ngpt),
                inc=u(0.0, 5.0, ncol, ngpt), ssa=u(0.05, 0.6, ncol, nlay, ngpt),
                g=u(0.0, 0.7, ncol, nlay, ngpt),
                jac=u(0.5, 2.0, ncol, ngpt), ds=u(1.2, 2.2, ncol, ngpt))


LW_VARIANTS = {
    "one-angle": dict(ds=(1.66,), weights=(0.5,)),
    "rescaled": dict(ds=(1.66,), weights=(0.5,), do_rescaling=True),
    "jacobian": dict(ds=(1.66,), weights=(0.5,), do_jacobians=True),
    "three-angles": dict(ds=GAUSS_DS[2], weights=GAUSS_WTS[2]),
    "secants": dict(weights=(1.0,)),
}


@pytest.mark.parametrize("variant", sorted(LW_VARIANTS))
def test_lw_solver_grads_match_jax(variant):
    """One angle with a scalar secant takes the port's adjoint Function;
    the others take the twin's gradient. Weighted loss on up, down and,
    with the Jacobian, the Jacobian."""
    p = lw_solver_problem(np.random.default_rng(5))
    kw = LW_VARIANTS[variant]
    rescale = kw.get("do_rescaling", False)
    jacobian = kw.get("do_jacobians", False)
    if variant != "secants":
        del p["ds"]
    if not rescale:
        del p["ssa"], p["g"]
    if not jacobian:
        del p["jac"]
    nlev = p["lev"].shape[1]
    w_t = torch.linspace(0.5, 1.5, nlev, dtype=torch.float64)
    w_j = jnp.linspace(0.5, 1.5, nlev)

    def loss(solver, w, s, **x):
        opts = dict(kw)
        if "ds" in x:
            opts["ds"] = (x["ds"],)
        f = solver(x["tau"], x["lay"], x["lev"], x["emis"], x["ssrc"],
                   x["inc"], top_at_1=True, ssa=x.get("ssa"), g=x.get("g"),
                   sfc_src_jac=x.get("jac"), **opts)
        out = s(w * f.flux_up) + 0.5 * s(w * f.flux_dn)
        if jacobian:
            out = out + 0.25 * s(w * f.flux_up_jac)
        return out

    def ref(**x):
        done = jax_pallas(False)
        try:
            return loss(jax_lw_solver, w_j, jnp.sum, **x)
        finally:
            done()

    got = port_grads(lambda **x: loss(lw_solver_noscat, w_t, torch.sum, **x),
                     p)
    assert_grads(got, jax_grads(ref, p), SOLVER_TOL, len(p) - 1)


def sw_problem(rng, ncol=4, nlay=6, ngpt=16):
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    return dict(tau=u(0.05, 1.5, ncol, nlay, ngpt),
                ssa=u(0.2, 0.95, ncol, nlay, ngpt),
                g=u(0.0, 0.8, ncol, nlay, ngpt),
                mu0=u(0.2, 1.0, ncol, 1) * np.linspace(1.0, 0.95, nlay),
                alb_dir=u(0.05, 0.5, ncol, ngpt),
                alb_dif=u(0.05, 0.5, ncol, ngpt), inc=u(2.0, 8.0, ncol, ngpt),
                incdif=u(0.0, 2.0, ncol, ngpt))


def sw_losses(ncol, nlay):
    w_t = torch.linspace(0.5, 1.5, nlay + 1, dtype=torch.float64)
    w_j = jnp.linspace(0.5, 1.5, nlay + 1)

    def loss(solver, w, s, tau, ssa, g, mu0, alb_dir, alb_dif, inc,
             incdif=None):
        f = solver(tau, ssa, g, mu0, alb_dir, alb_dif, inc, top_at_1=True,
                   inc_flux_dif=incdif)
        return (s(w * f.flux_up) + 0.5 * s(w * f.flux_dn)
                + 0.25 * s(w * f.flux_dir))

    def ref(**x):
        done = jax_pallas(False)
        try:
            return loss(jax_sw_solver, w_j, jnp.sum, **x)
        finally:
            done()
    return (lambda **x: loss(sw_solver_2stream, w_t, torch.sum, **x)), ref


def test_sw_solver_grads_match_jax():
    """Broadband sw_solver_2stream takes the port's adjoint Function."""
    p = sw_problem(np.random.default_rng(4))
    port, ref = sw_losses(4, 6)
    assert_grads(port_grads(port, p), jax_grads(ref, p), SOLVER_TOL, len(p))


def sw_edge_problem():
    """tests/test_r5_regressions.py::_sw_edge_problem."""
    rng = np.random.default_rng(0)
    ncol, nlay, ngpt = 6, 5, 16
    tau = rng.uniform(0.1, 2.0, (ncol, nlay, ngpt))
    tau[0] = 1e-8          # near-transparent column
    tau[1] = 80.0          # optically enormous column
    mu0 = np.full((ncol, nlay), 0.6)
    mu0[2] = -0.3          # night column
    mu0[3] = 0.0           # terminator
    return dict(tau=tau, ssa=rng.uniform(0.2, 0.9, (ncol, nlay, ngpt)),
                g=rng.uniform(0.0, 0.8, (ncol, nlay, ngpt)), mu0=mu0,
                alb_dir=np.full((ncol, ngpt), 0.2),
                alb_dif=np.full((ncol, ngpt), 0.2),
                inc=rng.uniform(1.0, 5.0, (ncol, ngpt)))


def test_sw_edge_grads_match_jax_f64():
    p = sw_edge_problem()
    port, ref = sw_losses(6, 5)
    assert_grads(port_grads(port, p), jax_grads(ref, p), SW_TOL, 4)


def test_sw_edge_grads_finite_f32():
    p = sw_edge_problem()
    leaves = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for k, v in p.items()}
    f = sw_solver_2stream(*leaves.values(), top_at_1=True)
    loss = f.flux_up.sum() + f.flux_dn.sum() + f.flux_dir.sum()
    got = dict(zip(leaves, torch.autograd.grad(loss,
                                               list(leaves.values()))))
    for k, v in got.items():
        assert bool(torch.isfinite(v).all()), k
    # the night column's fluxes are zero, so its tau gradient vanishes
    assert bool((got["tau"][2] == 0).all())
