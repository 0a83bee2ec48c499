"""The minor-gas gather out of place (``ops/kernels/gas_minor.py::
gas_minor`` with ``out``; ``models/rrtmgp/gas_optics.py::_minor``), on
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
output, while the in-place call hands it tau as both.
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


def _setup(dtype):
    """The JAX and port gas optics on one synthetic LW table set, the
    all-sky atmosphere for both, and each side's descriptors."""
    jkd = jax_kdist(sw=False, dtype=getattr(jnp, dtype), ngpt=NGPT, nbnd=4,
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
