"""Fused SW: the port's sw_fused twin against the JAX package.

The shapes of tests/test_fused_autodiff.py (8 columns x 8 layers, 32
g-points in 4 bands, ntemp 5, npres 10). The atmosphere is the all-sky
one with numpy-seeded perturbations (layer temperatures, per-column
mu0 with one night column, per-g-point albedos, by-band delta-scaled
cloud tau/ssa/g), the same arrays given to both packages, which hold the
same tables (convert.py).

  * float32 against the Pallas kernel ``sw_fused_gas_optics_solve`` in
    interpret mode. The Pallas kernel hard-codes float32 eps/tiny, so
    the comparison is in float32; the two sum interpolation corners,
    g-points and the adding recurrences in different orders: measured
    1.5e-7 of the largest flux, bound 2e-6 (about 16 float32 ulps).
  * float64 against ``_sw_fused_xla_ref``, which keeps float32's tiny in
    its cloud combine as the twin does: measured 4e-16, bound 1e-12 of
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
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused, sw_fused_plain)

NCOL, NLAY, NGPT, NBND = 8, 8, 32, 4
SIZES = dict(ngpt=NGPT, nbnd=NBND, ntemp=5, npres=10)


def problem(seed=11):
    """numpy arrays of one perturbed all-sky atmosphere."""
    rng = np.random.default_rng(seed)
    inp = make_allsky_inputs(NCOL, NLAY, dtype=torch.float64, device="cpu")
    arr = {k: getattr(inp, k).numpy() for k in ("play", "plev", "tlay")}
    arr["tlay"] = arr["tlay"] + rng.uniform(-5.0, 5.0, arr["tlay"].shape)
    mu0 = rng.uniform(0.05, 1.0, NCOL)
    mu0[3] = 0.0                                        # a night column
    arr["mu0"] = np.broadcast_to(mu0, (NLAY, NCOL)).copy()
    arr["alb_dir"] = rng.uniform(0.02, 0.6, (NGPT, NCOL))
    arr["alb_dif"] = rng.uniform(0.02, 0.6, (NGPT, NCOL))
    shape = (NBND, NLAY, NCOL)
    arr["cld_tau"] = np.where(rng.uniform(size=shape) < 0.5, 0.0,
                              rng.uniform(0.0, 5.0, shape))
    arr["cld_ssa"] = rng.uniform(0.5, 1.0, shape)
    arr["cld_g"] = rng.uniform(0.0, 0.9, shape)
    gases = {g: inp.gas_concs.get_vmr(g, NCOL, NLAY).numpy()
             for g in inp.gas_concs.names}
    return arr, gases


def run_both(dtype, pallas):
    arr, gases = problem()
    jkd = jax_kdist(sw=True, dtype=getattr(jnp, dtype), **SIZES)
    jgas = JGasOptics(jkd)
    tdt = getattr(torch, dtype)
    gas = GasOpticsRRTMGP(kdist_from_jax(jkd, dtype=tdt, device="cpu"))
    jgc, gc = JGasConcs.empty(), GasConcs.empty()
    for k, v in gases.items():
        jgc, gc = jgc.set_vmr(k, v), gc.set_vmr(k, v)
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in arr.items()}
    t = {k: torch.as_tensor(v, dtype=tdt) for k, v in arr.items()}
    cloud = lambda d: (d["cld_tau"], d["cld_ssa"], d["cld_g"])
    got = gas.sw_fused_solve(t["play"], t["plev"], t["tlay"], gc,
                             mu0=t["mu0"], sfc_alb_dir=t["alb_dir"],
                             sfc_alb_dif=t["alb_dif"], cloud=cloud(t))
    if pallas:
        set_use_pallas(True)
        try:
            ref = jgas.sw_fused_solve(
                j["play"], j["plev"], j["tlay"], jgc, mu0=j["mu0"],
                sfc_alb_dir=j["alb_dir"], sfc_alb_dif=j["alb_dif"],
                cloud=cloud(j))
        finally:
            set_use_pallas(None)
        assert ref is not None, "the JAX fused SW kernel did not run"
    else:
        inc = jnp.broadcast_to(jkd.solar_source[:, None], (NGPT, NCOL))
        ref = jgas._sw_fused_xla_ref(
            j["play"], j["plev"], j["tlay"], jgc, j["mu0"], j["alb_dir"],
            j["alb_dif"], inc, None, None, cloud(j), byband=False)
    return got, ref


@pytest.mark.parametrize("dtype,pallas,tol", [
    ("float32", True, 2e-6),
    ("float64", False, 1e-12),
], ids=["f32-pallas-interpret", "f64-xla-ref"])
def test_sw_fused_twin_matches_jax(dtype, pallas, tol):
    got, ref = run_both(dtype, pallas)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == (NLAY + 1, NCOL)
        assert g.dtype == getattr(torch, dtype)
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= tol * scale, (
            np.abs(g.numpy() - r).max(), tol * scale)
    up, dn, fdir = got
    assert bool((dn[:, 3] == 0).all()) and bool((up[:, 3] == 0).all()), (
        "a night column has no SW flux")


def test_sw_fused_dispatch_on_cpu():
    """A CPU tensor goes to the twin; the launch counter does not move."""
    arr, gases = problem()
    gas = GasOpticsRRTMGP(kdist_from_jax(jax_kdist(sw=True, **SIZES),
                                         device="cpu"))
    gc = GasConcs.empty()
    for k, v in gases.items():
        gc = gc.set_vmr(k, v)
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in arr.items()}
    x = gas.sw_fused_inputs(t["play"], t["plev"], t["tlay"], gc,
                            mu0=t["mu0"], sfc_alb_dir=t["alb_dir"],
                            sfc_alb_dif=t["alb_dif"],
                            cloud=(t["cld_tau"], t["cld_ssa"], t["cld_g"]))
    before = sw_fused.launches
    out = sw_fused(x)
    assert sw_fused.launches == before
    for a, b in zip(out, sw_fused_plain(x)):
        assert torch.equal(a, b)
