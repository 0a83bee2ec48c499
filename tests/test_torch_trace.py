"""The port's tracing (``rte_rrtmgp_tpu_torch/trace.py``) on the CPU.

  * Off (no ``collect()`` block open), ``span``, ``wait`` and a
    ``spanned`` function cost a call: one shared no-op object, nothing
    recorded.
  * Under ``collect()``: nesting sets each span's parent and request, a
    second thread starts a stack (and a request) of its own, ``wait``
    counts, ``count`` adds to its counter (nothing while off), the
    kernels' ``.launches`` are read and left as they are.
  * Whole steps at 24 columns (the fused all-sky step, the public API,
    RFMIP, the fused step's gradient): the layer spans with their parents,
    the same number of waits on two consecutive steps, each on new cloud
    fields, equal to the count of host waits PERF.md documents for each
    path (on the card, ``torch.cuda.set_sync_debug_mode`` counts them):
    the SW call's cloud check returns on the LW call's (one
    ``check.cloud.reused``), and a step repeated on the same fields reads
    them again, once; outputs bit for bit those of the step with tracing
    off.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch import trace  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_step_lw, allsky_step_sw,
    build_allsky)
from rte_rrtmgp_tpu_torch.drivers.rfmip import (  # noqa: E402
    rfmip_lw_sw, synthetic_rfmip)
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP)
from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (  # noqa: E402
    cloud_props)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import lw_fused  # noqa: E402
from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist  # noqa: E402


def test_off_is_one_shared_noop():
    calls = []
    f = trace.spanned("f")(lambda x: calls.append(x) or x + 1)
    a, b, w = trace.span("a"), trace.span("b"), trace.wait("w")
    assert a is b is w
    with a as inner:
        assert inner is a
        assert f(1) == 2
    assert calls == [1]
    assert trace._rec is None
    assert not getattr(trace._local, "stack", [])
    with trace.collect() as rec:
        pass
    assert rec.spans == [] and rec.counters["waits"] == 0
    assert trace.span("a") is a


def test_nesting_parents_requests_and_threads():
    seen = {}

    def other():
        with trace.span("t.outer"):
            with trace.span("t.inner"):
                seen["thread"] = threading.get_ident()

    with trace.collect() as rec:
        with trace.span("a"):
            with trace.span("b"):
                trace.spanned("c")(lambda: None)()
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
        with trace.span("d"):
            pass
    assert not th.is_alive()
    rows = {r[0]: r for r in rec.spans}
    assert set(rows) == {"a", "b", "c", "d", "t.outer", "t.inner"}
    main = threading.get_ident()
    assert rows["a"][1:4] == (rows["a"][1], None, main)
    assert rows["b"][1:4] == (rows["a"][1], "a", main)
    assert rows["c"][1:4] == (rows["a"][1], "b", main)
    assert rows["t.outer"][2:4] == (None, seen["thread"])
    assert rows["t.inner"][1:4] == (rows["t.outer"][1], "t.outer",
                                    seen["thread"])
    assert len({rows[k][1] for k in ("a", "t.outer", "d")}) == 3
    for name, _, _, _, t0, t1 in rec.spans:
        assert 0 < t0 <= t1, name
    a, b = rows["a"], rows["b"]
    assert a[4] <= b[4] <= b[5] <= a[5]
    (p0, e0), (p1, e1) = rec.clock
    assert p0 <= a[4] and a[5] <= p1
    assert e0 <= rec.epoch_ns(a[4]) <= rec.epoch_ns(a[5]) <= e1


def test_wait_counts_and_nests():
    with trace.collect() as rec:
        with trace.span("check.x"):
            with trace.wait("site"):
                pass
        with trace.wait("other"):
            pass
    assert rec.counters["waits"] == 2
    assert [(r[0], r[2]) for r in rec.spans] == [
        ("wait.site", "check.x"), ("check.x", None), ("wait.other", None)]


def test_count_adds_inside_collect_and_nothing_off():
    assert trace.count("x.n", 5) is None           # off: nothing kept
    with trace.collect() as rec:
        trace.count("x.n")
        trace.count("x.n", 3)
        trace.count("x.bytes", 1 << 40)
    assert rec.counters["x.n"] == 4 and rec.counters["x.bytes"] == 1 << 40
    trace.count("x.n")
    assert rec.counters["x.n"] == 4


def test_collect_reads_launches_and_does_not_nest():
    before = (cloud_props.launches, lw_fused.launches)
    with trace.collect() as rec:
        cloud_props.launches += 3           # as three launches would
        with pytest.raises(RuntimeError, match="already open"):
            with trace.collect():
                pass
    cloud_props.launches -= 3
    assert (cloud_props.launches, lw_fused.launches) == before
    assert rec.counters["launches.cloud_props"] == 3
    assert rec.counters["launches.lw_fused"] == 0
    assert trace._rec is None


NCOL, NLAY = 24, 16


@pytest.fixture(scope="module")
def allsky():
    return build_allsky(NCOL, NLAY, 32, 4, 28, 4, 5, 9, device="cpu")


def _fused(p, x):
    lw = allsky_step_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
    sw = allsky_step_sw(x, p.gas_sw, cloud_optics=p.cld_sw)
    return lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir


def _api(p, x):
    lw = allsky_api_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
    sw = allsky_api_sw(x, p.gas_sw, cloud_optics=p.cld_sw)
    return lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir


def _grad(p, x):
    """The fused step's gradient in tlay and the water vapour, the leaves
    set as a user sets them (``GasConcs.set_vmr``)."""
    tlay = x.tlay.detach().clone().requires_grad_()
    h2o = x.gas_concs.get_vmr("h2o", NCOL, NLAY).detach().clone()
    h2o.requires_grad_()
    y = x._replace(tlay=tlay, gas_concs=x.gas_concs.set_vmr("h2o", h2o))
    loss = sum(f.sum() for f in _fused(p, y))
    return torch.autograd.grad(loss, (tlay, h2o))


# (step, waits per step (PERF.md), (span, parent) pairs it must record)
PATHS = {
    "fused": (_fused, 1, {
        ("allsky.lw", None), ("allsky.sw", None),
        ("cloud.optics", "allsky.lw"), ("check.cloud", "cloud.optics"),
        ("wait.cloud.ranges", "check.cloud"),
        ("kernel.cloud_props", "cloud.optics"),
        ("gas.fused_inputs", "allsky.sw"),
        ("gas.descriptors", "gas.fused_inputs"),
        ("check.key_species", "gas.descriptors"),
        ("kernel.gas_descriptors", "gas.descriptors"),
        ("gas.minor_scaling", "gas.descriptors"),
        ("kernel.lw_fused", "allsky.lw"), ("kernel.sw_fused", "allsky.sw")}),
    "api": (_api, 11, {
        ("allsky_api.lw", None), ("allsky_api.sw", None),
        ("wait.cloud.ranges", "check.cloud"),
        ("gas.descriptors", "allsky_api.lw"),
        ("kernel.gas_descriptors", "gas.descriptors"),
        ("gas.minor_scaling", "allsky_api.sw"),
        ("optics.major", "allsky_api.lw"),
        ("kernel.gas_major", "optics.major"),
        ("kernel.gas_minor", "optics.minor"),
        ("kernel.gas_rayleigh", "optics.rayleigh"),
        ("sources.planck", "allsky_api.lw"),
        ("wait.planck.gpt2band", "sources.planck"),
        ("optics.increment", "allsky_api.sw"),
        ("wait.increment.gpt2band", "optics.increment"),
        ("optics.delta_scale", "allsky_api.sw"),
        ("rte.lw", "allsky_api.lw"), ("rte.sw", "allsky_api.sw"),
        ("check.props", "rte.sw"), ("wait.props.g", "check.props"),
        ("check.mu0", "rte.sw"), ("wait.mu0", "check.mu0"),
        ("kernel.lw_noscat", "rte.lw"), ("kernel.sw_2stream", "rte.sw")}),
    "grad": (_grad, 2, {
        ("check.vmr", None), ("wait.vmr", "check.vmr"),
        ("allsky.lw", None), ("kernel.lw_fused", "allsky.lw"),
        ("backward.lw_fused", None), ("backward.sw_fused", None),
        ("kernel.gas_descriptors", "gas.descriptors"),
        ("backward.gas_descriptors", None)}),
}


def _fresh_clouds(x):
    """``x`` with copies of its cloud fields: a new state, whose cloud
    check no earlier check has seen."""
    return x._replace(lwp=x.lwp.clone(), iwp=x.iwp.clone(),
                      rel=x.rel.clone(), dei=x.dei.clone())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_step_spans_waits_and_bits(allsky, path):
    step, waits, pairs = PATHS[path]
    x = allsky.inputs
    off = step(allsky, x)
    recs, outs = [], []
    for _ in range(2):
        y = _fresh_clouds(x)
        with trace.collect() as rec:
            outs.append(step(allsky, y))
        recs.append(rec)
    for rec, out in zip(recs, outs):
        assert rec.counters["waits"] == waits
        assert rec.counters["check.cloud.reused"] == 1
        got = {(r[0], r[2]) for r in rec.spans}
        assert pairs <= got, sorted(pairs - got)
        assert sum(r[0].startswith("wait.") for r in rec.spans) == waits
        assert sum(r[0] == "wait.cloud.ranges" for r in rec.spans) == 1
        for a, b in zip(off, out):
            assert torch.equal(a, b)
    # the same state again: the record is spent by the SW call that
    # returned on it, so the LW call reads again and the SW call reuses
    with trace.collect() as rec:
        out = step(allsky, y)
    assert rec.counters["waits"] == waits
    assert rec.counters["check.cloud.reused"] == 1
    assert sum(r[0] == "wait.cloud.ranges" for r in rec.spans) == 1
    for a, b in zip(off, out):
        assert torch.equal(a, b)


def test_rfmip_spans_waits_and_bits():
    gas_lw = GasOpticsRRTMGP(synthetic_kdist(
        sw=False, ngpt=32, nbnd=4, ntemp=6, npres=12, device="cpu"))
    gas_sw = GasOpticsRRTMGP(synthetic_kdist(
        sw=True, ngpt=32, nbnd=4, ntemp=6, npres=12, device="cpu"))
    data = synthetic_rfmip(6, 20, 3)
    off = rfmip_lw_sw(data, gas_lw, gas_sw)
    for _ in range(2):
        with trace.collect() as rec:
            out = rfmip_lw_sw(data, gas_lw, gas_sw)
        assert rec.counters["waits"] == 1
        assert "check.cloud.reused" not in rec.counters
        got = {(r[0], r[2]) for r in rec.spans}
        assert {("rfmip.lw_sw", None),
                ("gas.fused_inputs", "rfmip.lw_sw"),
                ("kernel.lw_fused", "rfmip.lw_sw"),
                ("kernel.sw_fused", "rfmip.lw_sw"),
                ("wait.rfmip.readback", "rfmip.lw_sw")} <= got
        for a, b in zip(off, out):
            np.testing.assert_array_equal(a, b)
