"""The public API path as a whole: gas_optics_lw/sw -> cloud_optics ->
increment -> rte_lw/rte_sw (``drivers/allsky.allsky_api_lw/sw``).

  * The slice gate: in float64 on the CPU (every kernel's plain twin)
    its fluxes sit within the reference's DP gate, 7e-4 W/m2
    (tests/test_golden_regression.py:22), of tests/golden/allsky.npz
    (12 x 24, 32 g-points in 4 bands; its cloud fields) and
    tests/golden/production.npz (256 x 72 at the full spectral widths;
    every field). The goldens are the JAX package's float64 XLA path of
    this very branch (set_use_pallas(False), drivers/allsky.py:393-446).
  * Against the JAX package's generic branch on the same inputs, float64:
    broadband and by-band fluxes (bound 1e-12 relative), and the public
    cloud_optics (both scatterings).
  * Against the port's fused step on the same float32 inputs (the JAX
    package's own fused-vs-generic bound, rtol 3e-5 / atol 5e-4 W/m2,
    tests/test_pallas_gas_optics.py:275).
  * By-band output off the CPU goes to the kernel wrappers, never to the
    twins: a float64 or wrongly shaped tensor there raises from the
    wrapper's argument checks, and runs nothing.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.drivers import allsky as jallsky  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics as jax_cloud, synthetic_kdist as jax_kdist)
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_step_lw, allsky_step_sw,
    build_allsky)
from rte_rrtmgp_tpu_torch.optical_props import (  # noqa: E402
    delta_scale, increment)
from rte_rrtmgp_tpu_torch.rte import rte_lw, rte_sw  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
DP_THRESHOLD = 7.0e-4
CASES = {"allsky": (12, 24, 32, 4, 32, 4, 6, 12),
         "production": (256, 72, 256, 16, 224, 14, 14, 59)}


@pytest.fixture(scope="module")
def problems():
    return {k: build_allsky(*dims, device="cpu", dtype=torch.float64)
            for k, dims in CASES.items()}


@pytest.mark.parametrize("band", ["lw", "sw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_public_path_matches_golden(problems, case, band):
    p = problems[case]
    golden = np.load(os.path.join(GOLDEN_DIR, f"{case}.npz"))
    if band == "lw":
        f = allsky_api_lw(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
        fields = {"lw_up": f.flux_up, "lw_dn": f.flux_dn}
    else:
        f = allsky_api_sw(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
        fields = {"sw_up": f.flux_up, "sw_dn": f.flux_dn}
        if "sw_dir" in golden:
            fields["sw_dir"] = f.flux_dn_dir
    for k, v in fields.items():
        assert v.shape == golden[k].shape and v.dtype == torch.float64
        d = float(np.abs(v.numpy() - golden[k]).max())
        assert d <= DP_THRESHOLD, f"{case}/{k}: {d:.3e} W/m2 from the golden"


def jax_problem():
    """The JAX package's objects for the port's allsky case."""
    dims = CASES["allsky"]
    kw = dict(ngpt=dims[2], nbnd=dims[3], ntemp=dims[6], npres=dims[7],
              dtype=jnp.float64)
    kd_lw, kd_sw = jax_kdist(sw=False, **kw), jax_kdist(sw=True, **kw)
    cld = lambda kd: jax_cloud(nbnd=dims[3],
                               band_lims_wvn=kd.grid.band_lims_wvn_array,
                               dtype=jnp.float64)
    inp = jallsky.make_allsky_inputs(dims[0], dims[1], cloud_optics=cld(kd_lw),
                                     dtype=jnp.float64)
    return (JGasOptics(kd_lw), JGasOptics(kd_sw), cld(kd_lw), cld(kd_sw),
            inp)


@pytest.mark.parametrize("byband", [False, True], ids=["broadband",
                                                       "byband"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_public_path_matches_jax_generic_branch(problems, band, byband):
    p = problems["allsky"]
    jgas_lw, jgas_sw, jcld_lw, jcld_sw, jinp = jax_problem()
    set_use_pallas(False)
    try:
        if band == "lw":
            ref = jallsky.allsky_step_lw(jinp, jgas_lw, cloud_optics=jcld_lw,
                                         byband=byband)
        else:
            ref = jallsky.allsky_step_sw(jinp, jgas_sw, cloud_optics=jcld_sw,
                                         byband=byband)
    finally:
        set_use_pallas(None)
    i = p.inputs
    if band == "lw":
        props, src = p.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                            i.gas_concs, tlev=i.tlev)
        props = increment(props, p.cld_lw.cloud_optics(
            i.lwp, i.iwp, i.rel, i.dei, scattering=False))
        got = rte_lw(props, src, i.sfc_emis, byband=byband)
        names = ("flux_up", "flux_dn", "flux_net")
    else:
        props, toa = p.gas_sw.gas_optics_sw(i.play, i.plev, i.tlay,
                                            i.gas_concs)
        props = increment(props, delta_scale(p.cld_sw.cloud_optics(
            i.lwp, i.iwp, i.rel, i.dei)))
        got = rte_sw(props, i.mu0, toa, i.sfc_alb, i.sfc_alb, byband=byband)
        names = ("flux_up", "flux_dn", "flux_net", "flux_dn_dir")
    for n in names:
        r = np.asarray(getattr(ref, n))
        g = getattr(got, n).numpy()
        assert g.shape == r.shape, n
        np.testing.assert_allclose(g, r, rtol=1e-12,
                                   atol=1e-12 * np.abs(r).max(), err_msg=n)


@pytest.mark.parametrize("scattering", [False, True], ids=["1scl", "2str"])
def test_cloud_optics_matches_jax(problems, scattering):
    p = problems["allsky"]
    _, _, jcld, _, jinp = jax_problem()
    ref = jcld.cloud_optics(jinp.lwp, jinp.iwp, jinp.rel, jinp.dei,
                            scattering=scattering)
    i = p.inputs
    got = p.cld_lw.cloud_optics(i.lwp, i.iwp, i.rel, i.dei,
                                scattering=scattering)
    assert type(got).__name__ == type(ref).__name__
    assert got.grid.band_lims_gpt == tuple(map(tuple,
                                               ref.grid.band_lims_gpt))
    for f in ("tau", "ssa", "g") if scattering else ("tau",):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_public_path_matches_fused_step_float32(band):
    """The two paths of the port, on the same float32 inputs on the CPU
    (their twins), agree to the JAX package's fused-vs-generic bound."""
    p = build_allsky(*CASES["allsky"], device="cpu")
    if band == "lw":
        a = allsky_api_lw(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
        f = allsky_step_lw(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
        names = ("flux_up", "flux_dn")
    else:
        a = allsky_api_sw(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
        f = allsky_step_sw(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
        names = ("flux_up", "flux_dn", "flux_dn_dir")
    for n in names:
        assert getattr(a, n).dtype == torch.float32
        np.testing.assert_allclose(getattr(a, n).numpy(),
                                   getattr(f, n).numpy(), rtol=3e-5,
                                   atol=5e-4, err_msg=n)


def _off_the_cpu(monkeypatch):
    """Send the meta device to the solver wrappers' kernel branch, as a
    CUDA tensor goes (no card here), with the twins made to fail if
    reached."""
    from rte_rrtmgp_tpu_torch.ops.kernels import (solver_lw, solver_lw_2str,
                                                  solver_sw)
    on_card = lambda t, what: t.device.type == "cpu"

    def no_twin(*a, **k):
        raise AssertionError("the twin ran on a tensor off the CPU")
    for mod, twin in ((solver_lw, "lw_noscat_plain"),
                      (solver_lw_2str, "lw_2stream_plain"),
                      (solver_sw, "sw_2stream_plain")):
        monkeypatch.setattr(mod, "on_cpu", on_card)
        monkeypatch.setattr(mod, twin, no_twin)
    return solver_lw.lw_noscat, solver_lw_2str.lw_2stream, \
        solver_sw.sw_2stream


def test_byband_off_the_cpu_raises(problems, monkeypatch):
    """by-band output off the CPU reaches the kernel wrappers: rte_lw (the
    no-scattering and the two-stream solve) and rte_sw with float64
    tensors raise from the wrappers' dtype checks, and a gpt2band of the
    wrong length from their shape checks; no twin runs and nothing is
    launched."""
    from rte_rrtmgp_tpu_torch.config import checks_disabled
    from rte_rrtmgp_tpu_torch.optical_props import OpticalProps2str
    kernels = _off_the_cpu(monkeypatch)
    counts = [k.launches for k in kernels]
    p = problems["allsky"]
    i = p.inputs
    props, src = p.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                        i.gas_concs, tlev=i.tlev)
    meta = lambda x: x.to("meta")
    props_m = dataclasses.replace(props, tau=meta(props.tau))
    src_m = dataclasses.replace(src, **{f: meta(getattr(src, f)) for f in (
        "lay_source", "lev_source", "sfc_source", "sfc_source_jac")})
    props2_m = OpticalProps2str(tau=props_m.tau, ssa=0 * props_m.tau,
                                g=0 * props_m.tau, grid=props.grid)
    sprops, toa = p.gas_sw.gas_optics_sw(i.play, i.plev, i.tlay, i.gas_concs)
    sprops_m = dataclasses.replace(sprops, tau=meta(sprops.tau),
                                   ssa=meta(sprops.ssa), g=meta(sprops.g))
    with checks_disabled():
        with pytest.raises(ValueError, match="dtype torch.float64"):
            rte_lw(props_m, src_m, i.sfc_emis, byband=True)
        with pytest.raises(ValueError, match="dtype torch.float64"):
            rte_lw(props2_m, src_m, i.sfc_emis, byband=True,
                   use_2stream=True)
        with pytest.raises(ValueError, match="dtype torch.float64"):
            rte_sw(sprops_m, i.mu0, toa, i.sfc_alb, i.sfc_alb, byband=True)
    f32 = lambda x: meta(x).float()
    ncol, nlay, ngpt = props.tau.shape
    lay, lev = f32(props.tau), f32(src.lev_source)
    bc = f32(src.sfc_source)
    bad = torch.zeros(ngpt + 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="gpt2band has shape"):
        kernels[0](lay, lay, lev, bc, bc, bc, ds=1.66, weight=1.0,
                   gpt2band=bad, nband=4)
    with pytest.raises(ValueError, match="gpt2band has shape"):
        kernels[1](lay, lay, lay, lay, lev, bc, bc, bc, bad, nband=4)
    stau = f32(sprops.tau)
    sbc = f32(toa)
    with pytest.raises(ValueError, match="gpt2band has shape"):
        kernels[2](stau, stau, stau, f32(i.mu0[:, None].expand(ncol, nlay)),
                   sbc, sbc, sbc, None, bad[:-1].new_zeros(sbc.shape[1] + 1),
                   nband=4)
    assert [k.launches for k in kernels] == counts
