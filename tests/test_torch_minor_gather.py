"""The minor-gas and Rayleigh gathers out of place
(``ops/kernels/gas_minor.py::gas_minor`` and ``gas_rayleigh`` with
``out``; ``models/rrtmgp/gas_optics.py::_minor`` and ``_rayleigh``), on
the CPU.

The public and staged gas optics add each atmosphere's minor gases into a
new tensor: the kernel reads tau and writes the output, where it used to
add into a clone of tau. Here: ``_minor`` leaves its input untouched and
gives the values of the JAX package's ``tau_minor`` in float64 (bound
1e-12 of the largest value, as tests/test_torch_gas_optics_api.py), with
the gradient of its twin; ``gas_minor`` with and without ``out`` agree
bit for bit; and on the CUDA branch (taken here on CPU tensors with the
launch replaced by a record of its arguments) ``_minor`` hands the
launcher the caller's tau itself, no copy, and a separate contiguous
output, while the in-place call hands it tau as both. The same for the
Rayleigh gather with ssa, and for its split variant (0 + Rayleigh, the
staged path's ``split_rayleigh``), which hands the launcher no tau at all:
no zeros tensor, no clone; both match the JAX package's ``tau_rayleigh``
(XLA path) plus the absorption/Rayleigh combine in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.drivers.allsky import make_allsky_inputs as jinputs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JGasOptics)
from rte_rrtmgp_tpu.ops import gas_optics as jops  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import synthetic_kdist as jax_kdist  # noqa: E402
from rte_rrtmgp_tpu_torch.convert import kdist_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp import gas_optics as go  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import gas_minor as gm  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import _split_minors  # noqa: E402

NCOL, NLAY, NGPT = 16, 6, 32


def _setup(dtype, sw=False):
    """The JAX and port gas optics on one synthetic LW (or SW) table set,
    the all-sky atmosphere for both, and each side's descriptors."""
    jkd = jax_kdist(sw=sw, dtype=getattr(jnp, dtype), ngpt=NGPT, nbnd=4,
                    ntemp=6, npres=12)
    tdt = getattr(torch, dtype)
    gas = go.GasOpticsRRTMGP(kdist_from_jax(jkd, dtype=tdt, device="cpu"))
    inp = jinputs(NCOL, NLAY, dtype=getattr(jnp, dtype))
    t = {k: torch.as_tensor(np.array(getattr(inp, k)), dtype=tdt)
         for k in ("play", "plev", "tlay")}
    gc = GasConcs.empty()
    for k in inp.gas_concs.names:
        gc = gc.set_vmr(k, np.asarray(inp.gas_concs.get_vmr(k, NCOL, NLAY)))
    jgas = JGasOptics(jkd)
    jcg, _, jh2o = jgas._col_gas(inp.play, inp.plev, inp.tlay,
                                 inp.gas_concs, None)
    jco = jgas._interp(inp.play, inp.tlay, jcg)
    cg, _, h2o = gas.col_gas(t["play"], t["plev"], gc.to(dtype=tdt))
    co = gas.interp(t["play"], t["tlay"], cg)
    return jgas, inp, (jco, jcg, jh2o), gas, t, (co, cg, h2o)


def _port_args(gas, t, co, cg, h2o, lower, tau):
    kd = gas.kdist
    nlo = len(kd.minor_lower)
    minors = _split_minors(gas.minors)[0 if lower else 1]
    meta = gas.minor_meta[:nlo] if lower else gas.minor_meta[nlo:]
    mset = kd.minor_lower if lower else kd.minor_upper
    scaling = minor_scaling(co, mset, lower=lower, play=t["play"],
                            tlay=t["tlay"], col_gas=cg, idx_h2o=h2o)
    ktab = kd.kminor_lower if lower else kd.kminor_upper
    return (tau, co, ktab, minors, meta, scaling)


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_minor_out_of_place_matches_jax_f64(lower):
    jgas, inp, (jco, jcg, jh2o), gas, t, (co, cg, h2o) = _setup("float64")
    jkd = jgas.kdist
    tau0 = np.random.default_rng(3).uniform(0.0, 2.0, (NCOL, NLAY, NGPT))
    mset = jkd.minor_lower if lower else jkd.minor_upper
    ref = jops.tau_minor(
        jnp.asarray(tau0), jco,
        jkd.kminor_lower_x if lower else jkd.kminor_upper_x, lower=lower,
        minor_limits_gpt=mset.limits_gpt, kminor_start=mset.kminor_start,
        idx_minor=mset.idx_minor, idx_minor_scaling=mset.idx_minor_scaling,
        minor_scales_with_density=mset.scales_with_density,
        scale_by_complement=mset.scale_by_complement,
        minor_flavor=mset.flavor, play=inp.play, tlay=inp.tlay,
        col_gas=jcg, idx_h2o=jh2o)
    ref = np.asarray(ref)
    tau = torch.as_tensor(tau0).requires_grad_()
    before = tau.detach().clone()
    args = _port_args(gas, t, co, cg, h2o, lower, tau)
    n0 = gm.gas_minor.launches
    out = go._minor(*args)
    assert gm.gas_minor.launches == n0
    assert out.data_ptr() != tau.data_ptr()
    assert torch.equal(tau.detach(), before)          # input untouched
    err = np.abs(out.detach().numpy() - ref).max()
    assert err <= 1e-12 * np.abs(ref).max()
    # the twin's gradient: d(sum out)/d(tau) is 1 everywhere
    grad, = torch.autograd.grad(out.sum(), tau)
    assert torch.equal(grad, torch.ones_like(grad))


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_gas_minor_out_equals_in_place(lower):
    _, _, _, gas, t, (co, cg, h2o) = _setup("float32")
    tau0 = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 2.0, (NCOL, NLAY, NGPT)).astype(np.float32))
    args = _port_args(gas, t, co, cg, h2o, lower, tau0.clone())
    out = torch.empty_like(tau0)
    got = gm.gas_minor(*args, out=out)
    assert got is out and torch.equal(args[0], tau0)
    inplace = gm.gas_minor(*args)
    assert inplace is args[0]
    assert torch.equal(got, inplace)
    assert not torch.equal(got, tau0)       # the minors added something


def test_minor_passes_tau_itself_to_the_kernel(monkeypatch):
    """On the CUDA branch ``_minor`` launches the kernel once with the
    caller's tau (no clone) as input and a new contiguous tensor as
    output; the in-place ``gas_minor`` passes tau as both."""
    _, _, _, gas, t, (co, cg, h2o) = _setup("float32")
    calls = []
    monkeypatch.setattr(gm, "on_cpu", lambda x, what: False)
    monkeypatch.setattr(gm, "launch", lambda *a: calls.append(a[3:]))
    tau = torch.from_numpy(np.random.default_rng(5).uniform(
        0.0, 2.0, (NCOL, NLAY, NGPT)).astype(np.float32))
    args = _port_args(gas, t, co, cg, h2o, True, tau)
    n0 = gm.gas_minor.launches
    out = go._minor(*args)
    assert len(calls) == 1 and gm.gas_minor.launches == n0 + 1
    src, dst = calls[0][:2]
    assert src is tau
    assert dst is out and dst.data_ptr() != tau.data_ptr()
    assert dst.is_contiguous() and dst.shape == tau.shape
    gm.gas_minor(*args)
    assert calls[1][0] is tau and calls[1][1] is tau


# ---- the Rayleigh gather ----

def _rayleigh_setup(dtype):
    """The SW gas optics' Rayleigh arguments on both sides: the JAX
    package's (descriptors, krayl_x, keywords) and the port's (co, krayl,
    gpoint_flavor, col_h2o + col_dry)."""
    jgas, inp, (jco, _, jh2o), gas, t, (co, cg, h2o) = _setup(dtype, sw=True)
    jcg, jdry, _ = jgas._col_gas(inp.play, inp.plev, inp.tlay,
                                 inp.gas_concs, None)
    _, dry, _ = gas.col_gas(t["play"], t["plev"], _port_gas(inp, dtype))
    jkd = jgas.kdist
    jargs = (jco, jkd.krayl_x, dict(
        gpoint_flavor=jkd.gpoint_flavor,
        band_lims_gpt=jkd.grid.band_lims_gpt_array, col_gas=jcg,
        col_dry=jdry, idx_h2o=jh2o))
    return jargs, (co, gas.kdist.krayl, gas.gpoint_flavor,
                   (cg[h2o] + dry).contiguous())


def _port_gas(inp, dtype):
    gc = GasConcs.empty()
    for k in inp.gas_concs.names:
        gc = gc.set_vmr(k, np.asarray(inp.gas_concs.get_vmr(k, NCOL, NLAY)))
    return gc.to(dtype=getattr(torch, dtype))


@pytest.mark.parametrize("split", [False, True], ids=["ssa", "split"])
def test_rayleigh_out_of_place_matches_jax_f64(split):
    """``_rayleigh`` from tau (with ssa) or from no tau (the split
    variant: the Rayleigh optical depth alone) against the JAX package's
    tau_rayleigh (XLA path) plus the combine of its gas optics
    (models/rrtmgp/gas_optics.py:344-358), in float64 within 1e-12 of the
    largest value: tau untouched, no kernel launched on CPU tensors, and
    the twin's gradient with respect to tau (1 everywhere)."""
    (jco, jkrayl, jkw), ray_args = _rayleigh_setup("float64")
    ray = np.asarray(jops.tau_rayleigh(jco, jkrayl, **jkw), np.float64)
    tau0 = np.random.default_rng(6).uniform(0.0, 0.1, (NCOL, NLAY, NGPT))
    n0 = gm.gas_rayleigh.launches
    if split:
        out, ssa = go._rayleigh(None, *ray_args, False)
        ref, ref_ssa = ray, None
    else:
        tau = torch.tensor(tau0, requires_grad=True)
        before = tau.detach().clone()
        out, ssa = go._rayleigh(tau, *ray_args, True)
        ref = tau0 + ray
        ref_ssa = np.where(ref > 2.0 * np.finfo(np.float64).tiny,
                           ray / ref, 0.0)
        assert torch.equal(tau.detach(), before)
        assert out.data_ptr() != tau.data_ptr()
        grad, = torch.autograd.grad(out.sum(), tau)
        assert torch.equal(grad, torch.ones_like(grad))
    assert gm.gas_rayleigh.launches == n0
    assert out.shape == (NCOL, NLAY, NGPT)
    scale = np.abs(ref).max()
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-12 * scale
    if ref_ssa is None:
        assert ssa is None
    else:
        assert np.abs(ssa.detach().numpy() - ref_ssa).max() <= 1e-12


@pytest.mark.parametrize("scattering", [True, False], ids=["2str", "1scl"])
def test_gas_rayleigh_out_equals_in_place(scattering):
    """``gas_rayleigh`` with ``out`` equals the in-place call bit for bit,
    tau untouched; from no tau it equals the in-place call on a zeros
    tensor bit for bit (0 + x is x for the non-negative Rayleigh depth)."""
    _, ray_args = _rayleigh_setup("float32")
    tau0 = torch.from_numpy(np.random.default_rng(7).uniform(
        0.0, 2.0, (NCOL, NLAY, NGPT)).astype(np.float32))
    tau = tau0.clone()
    out = torch.empty_like(tau0)
    got = gm.gas_rayleigh(tau, *ray_args, scattering, out=out)
    assert got[0] is out and torch.equal(tau, tau0)
    inplace = gm.gas_rayleigh(tau, *ray_args, scattering)
    assert inplace[0] is tau
    for a, b in zip(got, inplace):
        assert (a is None and b is None) or torch.equal(a, b)
    assert not torch.equal(out, tau0)
    split = gm.gas_rayleigh(None, *ray_args, scattering,
                            out=torch.empty_like(tau0))
    zeros = gm.gas_rayleigh(torch.zeros_like(tau0), *ray_args, scattering)
    for a, b in zip(split, zeros):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="needs an out"):
        gm.gas_rayleigh(None, *ray_args, scattering)


def test_rayleigh_passes_tau_itself_to_the_kernel(monkeypatch):
    """On the CUDA branch ``_rayleigh`` launches the kernel once with the
    caller's tau (no clone) as input and a new contiguous tensor as
    output, and the SW gas optics' split path (``_taus(split_rayleigh=
    True)``) hands it no tau at all (no zeros tensor, no clone) and no
    ssa; the in-place ``gas_rayleigh`` passes tau as both."""
    jgas, inp, _, gas, t, _ = _setup("float32", sw=True)
    _, ray_args = _rayleigh_setup("float32")
    calls = []
    monkeypatch.setattr(gm, "on_cpu", lambda x, what: False)
    monkeypatch.setattr(gm, "launch", lambda *a: calls.append(a[1:]))
    tau = torch.from_numpy(np.random.default_rng(8).uniform(
        0.0, 2.0, (NCOL, NLAY, NGPT)).astype(np.float32))
    n0 = gm.gas_rayleigh.launches
    out, ssa = go._rayleigh(tau, *ray_args, True)
    assert len(calls) == 1 and gm.gas_rayleigh.launches == n0 + 1
    fn, what, src, dst, s = calls[0][:5]
    assert (fn, what) == ("launch_gas_rayleigh", "gas_rayleigh")
    assert src is tau and dst is out and s is ssa
    assert dst.data_ptr() != tau.data_ptr() and dst.is_contiguous()
    assert dst.shape == tau.shape
    gm.gas_rayleigh(tau, *ray_args, True)
    assert calls[1][2] is tau and calls[1][3] is tau
    # the split path of the SW gas optics: the minor gathers' launches are
    # recorded too (their outputs unset), the Rayleigh launch reads no tau
    del calls[:]
    _, second, _ = gas._taus(t["play"], t["plev"], t["tlay"],
                             _port_gas(inp, "float32"), None, False,
                             split_rayleigh=True)
    ray = [c for c in calls if c[0] == "launch_gas_rayleigh"]
    assert len(ray) == 1
    src, dst, s = ray[0][2:5]
    assert src is None and s is None and dst is second
