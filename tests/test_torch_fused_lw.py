"""Fused LW: the port's lw_fused twin against the JAX package.

The shapes of tests/test_fused_autodiff.py (8 columns x 8 layers, 32
g-points in 4 bands, ntemp 5, npres 10). The atmosphere is the all-sky
one with numpy-seeded perturbations (layer and surface temperatures,
per-g-point emissivity, by-band cloud absorption), the same arrays given
to both packages, which hold the same tables (convert.py).

  * float32 against the Pallas kernel ``lw_fused_gas_optics_solve`` in
    interpret mode (the JAX test suite's own way of running it on CPU).
    The Pallas kernel hard-codes float32 eps/tiny, so the comparison is
    in float32. The two sum the 8 interpolation corners, the g-points
    and the layer recurrences in different orders; measured 1.7e-7 of
    the largest flux, bound 2e-6 (about 16 float32 ulps).
  * float64 against ``_lw_fused_xla_ref``, the XLA formulation that
    defines the fused kernel's semantics: measured 3e-16, bound 1e-12 of
    the largest flux.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.gas_concs import GasConcs as JGasConcs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.utils.synthetic import synthetic_kdist as jax_kdist  # noqa: E402
from rte_rrtmgp_tpu_torch.convert import kdist_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import make_allsky_inputs  # noqa: E402
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    lw_fused, lw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS  # noqa: E402

NCOL, NLAY, NGPT, NBND = 8, 8, 32, 4
SIZES = dict(ngpt=NGPT, nbnd=NBND, ntemp=5, npres=10)


def problem(seed=7):
    """numpy arrays of one perturbed all-sky atmosphere."""
    rng = np.random.default_rng(seed)
    inp = make_allsky_inputs(NCOL, NLAY, dtype=torch.float64)
    arr = {k: getattr(inp, k).numpy() for k in ("play", "plev", "tlay",
                                                "tlev")}
    arr["tlay"] = arr["tlay"] + rng.uniform(-5.0, 5.0, arr["tlay"].shape)
    arr["tsfc"] = rng.uniform(280.0, 310.0, NCOL)
    arr["sfc_emis"] = rng.uniform(0.8, 1.0, (NGPT, NCOL))
    arr["cloud_tau_abs"] = np.where(rng.uniform(size=(NBND, NLAY, NCOL)) < 0.5,
                                    0.0, rng.uniform(0.0, 3.0,
                                                     (NBND, NLAY, NCOL)))
    gases = {g: inp.gas_concs.get_vmr(g, NCOL, NLAY).numpy()
             for g in inp.gas_concs.names}
    return arr, gases


def run_both(dtype, pallas):
    arr, gases = problem()
    jkd = jax_kdist(sw=False, dtype=getattr(jnp, dtype), **SIZES)
    jgas = JGasOptics(jkd)
    tdt = getattr(torch, dtype)
    gas = GasOpticsRRTMGP(kdist_from_jax(jkd, dtype=tdt))
    jgc, gc = JGasConcs.empty(), GasConcs.empty()
    for k, v in gases.items():
        jgc, gc = jgc.set_vmr(k, v), gc.set_vmr(k, v)
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in arr.items()}
    t = {k: torch.as_tensor(v, dtype=tdt) for k, v in arr.items()}
    kw = dict(ds=GAUSS_DS, weight=GAUSS_WTS)
    got = gas.lw_fused_solve(t["play"], t["plev"], t["tlay"], t["tsfc"], gc,
                             sfc_emis=t["sfc_emis"], tlev=t["tlev"],
                             cloud_tau_abs=t["cloud_tau_abs"], **kw)
    if pallas:
        set_use_pallas(True)
        try:
            ref = jgas.lw_fused_solve(
                j["play"], j["plev"], j["tlay"], j["tsfc"], jgc,
                sfc_emis=j["sfc_emis"], tlev=j["tlev"],
                cloud_tau_abs=j["cloud_tau_abs"], **kw)
        finally:
            set_use_pallas(None)
        assert ref is not None, "the JAX fused LW kernel did not run"
    else:
        ref = jgas._lw_fused_xla_ref(
            j["play"], j["plev"], j["tlay"], j["tsfc"], jgc, j["sfc_emis"],
            jnp.zeros((NGPT, NCOL), j["play"].dtype), j["tlev"], None,
            j["cloud_tau_abs"], byband=False, **kw)
    return got, ref


@pytest.mark.parametrize("dtype,pallas,tol", [
    ("float32", True, 2e-6),
    ("float64", False, 1e-12),
], ids=["f32-pallas-interpret", "f64-xla-ref"])
def test_lw_fused_twin_matches_jax(dtype, pallas, tol):
    got, ref = run_both(dtype, pallas)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == (NLAY + 1, NCOL)
        assert g.dtype == getattr(torch, dtype)
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= tol * scale, (
            np.abs(g.numpy() - r).max(), tol * scale)


def test_lw_fused_dispatch_on_cpu():
    """A CPU tensor goes to the twin; the launch counter does not move."""
    arr, gases = problem()
    gas = GasOpticsRRTMGP(kdist_from_jax(jax_kdist(sw=False, **SIZES)))
    gc = GasConcs.empty()
    for k, v in gases.items():
        gc = gc.set_vmr(k, v)
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in arr.items()}
    x = gas.lw_fused_inputs(t["play"], t["plev"], t["tlay"], t["tsfc"], gc,
                            sfc_emis=t["sfc_emis"], tlev=t["tlev"],
                            cloud_tau_abs=t["cloud_tau_abs"], ds=GAUSS_DS,
                            weight=GAUSS_WTS)
    before = lw_fused.launches
    up, dn = lw_fused(x)
    assert lw_fused.launches == before
    up0, dn0 = lw_fused_plain(x)
    assert torch.equal(up, up0) and torch.equal(dn, dn0)
    assert bool((dn[0] == 0).all()), "no incident LW flux at the top"
