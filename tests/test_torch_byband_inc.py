"""By-band output and incident fluxes of the port's fused steps, against
the JAX package (CPU).

  * The fused LW and SW solves with a non-zero incident flux (LW), a
    diffuse incident flux (SW), the dry-air columns given, clouds, and
    broadband or by-band output: forward fluxes and gradients with
    respect to the atmosphere, the incident fluxes and the dry-air
    columns, float64, against the JAX package's XLA reference of the
    fused step (``_lw/_sw_fused_xla_ref``) and against its fused Pallas
    kernels in interpret mode (by band: with_xla_grad, the JAX rule), at
    the bounds of tests/test_torch_autodiff.py (LW rtol 1e-8 / atol
    1e-12, SW rtol 1e-7 / atol 1e-11; forward 1e-10). The broadband
    gradients run through the adjoint Function (its twin's autograd on
    the CPU), the by-band ones through with_twin_grad: the JAX package's
    test_byband_fused_grad_matches_xla (tests/test_fused_autodiff.py:512)
    with the incident-flux cotangents of :462-510.
  * The fused adjoints' twins (``lw_fused_bwd_plain``,
    ``sw_fused_bwd_plain``, what the card's adjoint kernels are held
    against) give the incident flux's and the diffuse incident flux's
    cotangents (inc_b, incdif_b) of jax.grad.
  * The JAX package's test_fused_allsky_byband_matches_generic
    (tests/test_pallas_gas_optics.py:371): the all-sky fused step with
    byband=True against its generic branch, float32 (its bound rtol 3e-5
    / atol 5e-4 W/m2), and its band sums against the broadband step.
  * By-band output of the fused solves needs uniform bands, as in the
    JAX package, and raises otherwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.drivers import allsky as jallsky  # noqa: E402
from rte_rrtmgp_tpu.gas_concs import GasConcs as JGasConcs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics as jax_cloud, synthetic_kdist as jax_kdist)
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_step_lw, allsky_step_sw, make_allsky_inputs)
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP, get_col_dry)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    LW_DIFF, lw_fused, lw_fused_bwd_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    SW_DIFF, sw_fused, sw_fused_bwd_plain)
from rte_rrtmgp_tpu_torch.spectral import SpectralGrid  # noqa: E402
from rte_rrtmgp_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics, synthetic_kdist)
from test_torch_autodiff import (  # noqa: E402
    DS, LW_TOL, NBND, NCOL, NGPT, NLAY, SW_TOL, WT, _gc, assert_grads,
    atmosphere, gases_lw, gases_sw, jax_grads, jax_pallas, port_grads)

__all__ = ["gases_lw", "gases_sw"]      # module-scoped fixtures, reused
F64 = torch.float64
FWD = dict(rtol=1e-10, atol=1e-10)


def col_dry(a):
    """Dry-air columns of the atmosphere ``a``, perturbed by up to 5%."""
    cd = get_col_dry(torch.as_tensor(a["h2o"]), torch.as_tensor(a["plev"]))
    rng = np.random.default_rng(3)
    return cd.numpy() * rng.uniform(0.95, 1.05, cd.shape)


def band_weights(byband, nlev, nbnd=NBND):
    """Loss weights of the fluxes: (nlev, 1), or by band (nbnd, nlev, 1)."""
    w = np.linspace(0.5, 1.5, nlev)[:, None]
    return np.linspace(0.5, 2.0, nbnd)[:, None, None] * w if byband else w


def lw_case(gases_lw, byband, jax_kernel):
    """(arrays, port solve, JAX solve) of the fused LW step with an
    incident flux and the dry-air columns; each solve returns (up, dn)."""
    jgas, gas = gases_lw
    a, gases, rng = atmosphere()
    a["emis"] = rng.uniform(0.8, 1.0, (NGPT, NCOL))
    a["inc"] = rng.uniform(0.0, 5.0, (NGPT, NCOL))
    a["cld"] = np.where(rng.uniform(size=(NBND, NLAY, NCOL)) < 0.5, 0.0,
                        rng.uniform(0.0, 3.0, (NBND, NLAY, NCOL)))
    a["col_dry"] = col_dry(a)

    def port(play, plev, tlay, tlev, tsfc, h2o, o3, emis, inc, cld, col_dry):
        return gas.lw_fused_solve(
            play, plev, tlay, tsfc, _gc(GasConcs, gases, h2o=h2o, o3=o3),
            sfc_emis=emis, inc_flux=inc, tlev=tlev, col_dry=col_dry,
            cloud_tau_abs=cld, ds=DS, weight=WT, byband=byband)

    def ref(play, plev, tlay, tlev, tsfc, h2o, o3, emis, inc, cld, col_dry):
        gc = _gc(JGasConcs, gases, h2o=h2o, o3=o3)
        done = jax_pallas(jax_kernel)
        try:
            if jax_kernel:
                return jgas.lw_fused_solve(
                    play, plev, tlay, tsfc, gc, sfc_emis=emis, inc_flux=inc,
                    tlev=tlev, col_dry=col_dry, cloud_tau_abs=cld, ds=DS,
                    weight=WT, byband=byband)
            return jgas._lw_fused_xla_ref(play, plev, tlay, tsfc, gc, emis,
                                          inc, tlev, col_dry, cld, ds=DS,
                                          weight=WT, byband=byband)
        finally:
            done()

    return a, port, ref


def sw_case(gases_sw, byband, jax_kernel):
    """(arrays, port solve, JAX solve) of the fused SW step with direct
    and diffuse incident fluxes and the dry-air columns; each solve
    returns (up, dn, dir)."""
    jgas, gas = gases_sw
    a, gases, rng = atmosphere(11)
    del a["tlev"], a["tsfc"]
    a["mu0"] = (rng.uniform(0.2, 1.0, NCOL)[None, :]
                * np.linspace(1.0, 0.97, NLAY)[:, None])
    a["alb"] = rng.uniform(0.05, 0.4, (NGPT, NCOL))
    solar = np.asarray(jgas.kdist.solar_source)[:, None]
    a["inc"] = solar * rng.uniform(0.8, 1.0, (NGPT, NCOL))
    a["incdif"] = 0.05 * solar * rng.uniform(0.0, 1.0, (NGPT, NCOL))
    cut = rng.uniform(size=(NBND, NLAY, NCOL)) < 0.5
    a["ct"] = np.where(cut, 0.0, rng.uniform(0.0, 2.0, (NBND, NLAY, NCOL)))
    a["cs"] = rng.uniform(0.3, 0.99, (NBND, NLAY, NCOL))
    a["cg"] = rng.uniform(0.1, 0.9, (NBND, NLAY, NCOL))
    a["col_dry"] = col_dry(a)

    def port(play, plev, tlay, h2o, o3, mu0, alb, inc, incdif, ct, cs, cg,
             col_dry):
        return gas.sw_fused_solve(
            play, plev, tlay, _gc(GasConcs, gases, h2o=h2o, o3=o3), mu0=mu0,
            sfc_alb_dir=alb, sfc_alb_dif=alb, inc_flux=inc,
            inc_flux_dif=incdif, col_dry=col_dry, cloud=(ct, cs, cg),
            byband=byband)

    def ref(play, plev, tlay, h2o, o3, mu0, alb, inc, incdif, ct, cs, cg,
            col_dry):
        gc = _gc(JGasConcs, gases, h2o=h2o, o3=o3)
        done = jax_pallas(jax_kernel)
        try:
            if jax_kernel:
                return jgas.sw_fused_solve(
                    play, plev, tlay, gc, mu0=mu0, sfc_alb_dir=alb,
                    sfc_alb_dif=alb, inc_flux=inc, inc_flux_dif=incdif,
                    col_dry=col_dry, cloud=(ct, cs, cg), byband=byband)
            return jgas._sw_fused_xla_ref(play, plev, tlay, gc, mu0, alb, alb,
                                          inc, incdif, col_dry, (ct, cs, cg),
                                          byband=byband)
        finally:
            done()

    return a, port, ref


def check_case(a, port, ref, byband, tol, min_nonzero, nbnd_out=NBND):
    """Forward fluxes within FWD, then the gradients of a weighted flux
    loss within ``tol``."""
    out = port(**{k: torch.as_tensor(v, dtype=F64) for k, v in a.items()})
    jout = ref(**{k: jnp.asarray(v, jnp.float64) for k, v in a.items()})
    shape = ((nbnd_out,) if byband else ()) + (NLAY + 1, NCOL)
    for o, r in zip(out, jout):
        assert tuple(o.shape) == shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **FWD)
    w = band_weights(byband, NLAY + 1, nbnd_out)
    c = (1.0, 0.5, 0.25)
    t_loss = lambda **x: sum(ci * (torch.as_tensor(w) * f).sum()
                             for ci, f in zip(c, port(**x)))
    j_loss = lambda **x: sum(ci * jnp.sum(w * f)
                             for ci, f in zip(c, ref(**x)))
    got, ref = port_grads(t_loss, a), jax_grads(j_loss, a)
    # with the dry-air columns given, plev reaches neither package's
    # fluxes: no gradient in the port, zeros in JAX
    assert got.pop("plev") is None and not np.any(ref.pop("plev"))
    assert_grads(got, ref, tol, min_nonzero)


@pytest.mark.parametrize("jax_side", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_fused_inc_grads_match_jax(gases_lw, gases_sw, band, jax_side):
    """Broadband fused steps with incident fluxes and dry-air columns."""
    kernel = jax_side != "xla"
    if band == "lw":
        check_case(*lw_case(gases_lw, False, kernel), False, LW_TOL, 10)
    else:
        check_case(*sw_case(gases_sw, False, kernel), False, SW_TOL, 12)


@pytest.mark.parametrize("jax_side", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_byband_fused_grad_matches_xla(gases_lw, gases_sw, band, jax_side):
    """By-band fused steps (tests/test_fused_autodiff.py:512, with the
    incident fluxes and dry-air columns): the fluxes per band and the
    gradients of a band-weighted loss."""
    kernel = jax_side != "xla"
    if band == "lw":
        check_case(*lw_case(gases_lw, True, kernel), True, LW_TOL, 10)
    else:
        check_case(*sw_case(gases_sw, True, kernel), True, SW_TOL, 12)


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_fused_adjoint_twins_give_inc_cotangents(gases_lw, gases_sw, band):
    """The fused adjoints' plain twins return the incident flux's (LW) and
    the diffuse incident flux's (SW) cotangents of jax.grad of the XLA
    reference, for seeded flux cotangents."""
    rng = np.random.default_rng(13)
    if band == "lw":
        a, _, ref = lw_case(gases_lw, False, False)
        names, bwd, wrt = LW_DIFF, lw_fused_bwd_plain, ("inc",)
        jgas, gas = gases_lw
    else:
        a, _, ref = sw_case(gases_sw, False, False)
        names, bwd, wrt = SW_DIFF, sw_fused_bwd_plain, ("inc", "incdif")
        jgas, gas = gases_sw
    nout = 2 if band == "lw" else 3
    cots = [rng.uniform(0.5, 1.5, (NLAY + 1, NCOL)) for _ in range(nout)]
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in a.items()}
    _, gases, _ = atmosphere() if band == "lw" else atmosphere(11)
    gc = _gc(GasConcs, gases, h2o=t["h2o"], o3=t["o3"])
    if band == "lw":
        x = gas.lw_fused_inputs(t["play"], t["plev"], t["tlay"], t["tsfc"],
                                gc, sfc_emis=t["emis"], inc_flux=t["inc"],
                                tlev=t["tlev"], col_dry=t["col_dry"],
                                cloud_tau_abs=t["cld"], ds=DS, weight=WT)
    else:
        x = gas.sw_fused_inputs(t["play"], t["plev"], t["tlay"], gc,
                                mu0=t["mu0"], sfc_alb_dir=t["alb"],
                                sfc_alb_dif=t["alb"], inc_flux=t["inc"],
                                inc_flux_dif=t["incdif"],
                                col_dry=t["col_dry"],
                                cloud=(t["ct"], t["cs"], t["cg"]))
    got = dict(zip(names, bwd(x, *(torch.as_tensor(c) for c in cots))))
    keys = list(a)

    def loss(*v):
        out = ref(**dict(zip(keys, v)))
        return sum(jnp.sum(c * f) for c, f in zip(cots, out))

    jg = jax.grad(loss, argnums=tuple(keys.index(k) for k in wrt))(
        *(jnp.asarray(a[k], jnp.float64) for k in keys))
    tol = LW_TOL if band == "lw" else SW_TOL
    for k, r in zip(wrt, jg):
        assert got[k] is not None and tuple(got[k].shape) == (NGPT, NCOL)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), err_msg=k,
                                   **tol)
        assert bool((got[k] != 0).all())


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_fused_allsky_byband_matches_generic(band):
    """tests/test_pallas_gas_optics.py:371: allsky_step_*(byband=True),
    the fused kernels' per-band sums (their twins on the CPU), against the
    JAX package's generic spectral-and-reduce path, float32 (its bound);
    the band sums equal the broadband step's fluxes."""
    sw = band == "sw"
    kd = synthetic_kdist(sw=sw, ngpt=32, nbnd=4, ntemp=6, npres=12,
                         device="cpu")
    gop = GasOpticsRRTMGP(kd)
    cld = synthetic_cloud_optics(
        nbnd=4, band_lims_wvn=kd.grid.band_lims_wvn_array, device="cpu")
    inputs = make_allsky_inputs(128, 4, cloud_optics=cld, device="cpu")
    jkd = jax_kdist(sw=sw, ngpt=32, nbnd=4, ntemp=6, npres=12)
    jcld = jax_cloud(nbnd=4, band_lims_wvn=jkd.grid.band_lims_wvn_array)
    jinp = jallsky.make_allsky_inputs(128, 4, cloud_optics=jcld)
    step = allsky_step_sw if sw else allsky_step_lw
    jstep = jallsky.allsky_step_sw if sw else jallsky.allsky_step_lw
    launches = (sw_fused if sw else lw_fused).launches
    out = step(inputs, gop, cloud_optics=cld, byband=True)
    assert (sw_fused if sw else lw_fused).launches == launches
    set_use_pallas(False)
    try:
        ref = jstep(jinp, JGasOptics(jkd), cloud_optics=jcld, byband=True)
    finally:
        set_use_pallas(None)
    assert out.flux_up.shape == (128, 5, 4)
    for name in ("flux_up", "flux_dn") + (("flux_dn_dir",) if sw else ()):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=3e-5, atol=5e-4, err_msg=name)
    bb = step(inputs, gop, cloud_optics=cld)
    for name in ("flux_up", "flux_dn") + (("flux_dn_dir",) if sw else ()):
        np.testing.assert_allclose(getattr(out, name).sum(-1).numpy(),
                                   getattr(bb, name).numpy(), rtol=2e-5,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_fused_byband_needs_uniform_bands(gases_lw, gases_sw, band):
    """The JAX package's rule (models/rrtmgp/gas_optics.py:42-50): the
    fused solves' by-band output raises on a k-distribution whose bands
    differ in width; broadband output is unaffected."""
    _, gas = gases_lw if band == "lw" else gases_sw
    lims = [[1, 4], [5, 12], [13, 20], [21, 32]]
    grid = SpectralGrid.from_arrays(gas.grid.band_lims_wvn, lims)
    ragged = GasOpticsRRTMGP(dataclasses.replace(gas.kdist, grid=grid))
    a, gases, _ = atmosphere()
    t = {k: torch.as_tensor(v, dtype=F64) for k, v in a.items()}
    gc = _gc(GasConcs, gases)
    emis = torch.ones((NGPT, NCOL), dtype=F64)
    mu0 = torch.full((NLAY, NCOL), 0.5, dtype=F64)
    for byband in (True, False):
        if band == "lw":
            call = lambda: ragged.lw_fused_inputs(
                t["play"], t["plev"], t["tlay"], t["tsfc"], gc,
                sfc_emis=emis, ds=DS, weight=WT, byband=byband)
        else:
            call = lambda: ragged.sw_fused_inputs(
                t["play"], t["plev"], t["tlay"], gc, mu0=mu0,
                sfc_alb_dir=emis, sfc_alb_dif=emis, byband=byband)
        if byband:
            with pytest.raises(ValueError, match="uniform band widths"):
                call()
        else:
            assert call().byband is False
