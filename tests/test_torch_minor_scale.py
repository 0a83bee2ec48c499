"""The minor-gas scaling rows in one kernel launch per gas-optics call
(``ops/kernels/minor_scale.py``, ``csrc/minor_scale.cu``), on the CPU.

  * The window table ``GasOpticsRRTMGP`` builds once per k-distribution
    holds the k-distribution's minor windows field by field, lower
    atmosphere's first; the host rows are the same.
  * On CPU tensors the wrapper is the twin: the rows equal the two
    atmospheres' ``minor_scaling`` twins concatenated, bit for bit, in
    the fused layout (strided ``play.T`` / ``col_gas.transpose`` views)
    and the public one, and nothing is launched. No windows: an empty
    (0, *S) tensor.
  * The adjoint's closed form (the CUDA adjoint's arithmetic) equals
    autograd of the twin in float64 at 24 columns for the LW and SW
    k-distributions, in both layouts; ``gradcheck`` passes through the
    autograd node, on the twin's backward and on the adjoint's.
  * The CUDA branch, taken here on CPU tensors with the launcher replaced
    by the twins (the test records what it is handed): one launch per
    gas-optics call on the caller's tensors themselves (views, no copies,
    their strides) and the gas optics' table, so 2 a fused all-sky step
    and 2 adjoint launches a gradient step, the public API 2 a step too;
    the outputs those of the step on the twins, bit for bit; the
    launches inside ``kernel.minor_scale`` spans under
    ``gas.minor_scaling``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch import trace  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_step_lw, allsky_step_sw,
    build_allsky)
from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import autodiff  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import minor_scale as ms  # noqa: E402

NCOL, NLAY = 24, 9
FIELDS = ("idx_minor", "scales_with_density", "idx_minor_scaling",
          "scale_by_complement")


@pytest.fixture(scope="module")
def allsky():
    return build_allsky(NCOL, NLAY, 32, 4, 28, 4, 5, 9, device="cpu")


@pytest.fixture(scope="module")
def allsky64():
    return build_allsky(NCOL, NLAY, 32, 4, 28, 4, 5, 9, device="cpu",
                        dtype=torch.float64)


def _cells(p, gas, layout):
    """(tropo, play, tlay, col_gas, idx_h2o) as the gas optics hand them
    to the rows: the public (ncol, nlay) cells, or the fused layer-major
    views."""
    inp = p.inputs
    cg, _, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
    play, tlay = inp.play, inp.tlay
    if layout == "fused":
        play, tlay, cg = play.T, tlay.T, cg.transpose(1, 2)
    return gas.interp(play, tlay, cg).tropo, play, tlay, cg, h2o


def _twins(gas, tropo, play, tlay, cg, h2o):
    """The two atmospheres' minor_scaling twins, concatenated."""
    kd = gas.kdist
    co = gas.interp(play, tlay, cg)._replace(tropo=tropo)
    kw = dict(play=play, tlay=tlay, col_gas=cg, idx_h2o=h2o)
    return torch.cat([minor_scaling(co, kd.minor_lower, lower=True, **kw),
                      minor_scaling(co, kd.minor_upper, lower=False, **kw)])


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_window_table_matches_kdist(allsky, band):
    gas = getattr(allsky, "gas_" + band)
    kd = gas.kdist
    want = [(lower, *(int(getattr(mset, f)[m]) for f in FIELDS))
            for lower, mset in ((1, kd.minor_lower), (0, kd.minor_upper))
            for m in range(len(mset))]
    assert len(want) == len(gas.minors) > 0
    table = gas.minor_scale_table
    assert table.dtype == torch.int32 and table.device == kd.kmajor.device
    assert tuple(table.shape) == (len(want), 5) and table.is_contiguous()
    assert table.tolist() == [list(w) for w in want]
    assert list(gas.minor_windows) == want
    # the windows of the minor gathers (minors, minor_meta): same order
    assert [w[0] for w in want] == [m[0] for m in gas.minors]


@pytest.mark.parametrize("layout", ["fused", "public"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_cpu_wrapper_equals_twins(allsky, band, layout):
    gas = getattr(allsky, "gas_" + band)
    cells = _cells(allsky, gas, layout)
    n0 = (ms.minor_scale.launches, ms.minor_scale_bwd.launches)
    got = ms.minor_scale(*cells, gas.minor_windows, gas.minor_scale_table)
    ref = _twins(gas, *cells)
    assert got.is_contiguous() and got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert (ms.minor_scale.launches, ms.minor_scale_bwd.launches) == n0


def test_fused_inputs_take_the_rows(allsky):
    """The fused LW and SW inputs' minor_scale is the rows of the
    descriptors' cells, lower then upper, contiguous."""
    inp = allsky.inputs
    for gas in (allsky.gas_lw, allsky.gas_sw):
        co, msc, _, _, _ = gas._descriptors(inp.play, inp.plev, inp.tlay,
                                            inp.gas_concs)
        ref = _twins(gas, *_cells(allsky, gas, "fused"))
        assert msc.is_contiguous() and torch.equal(msc, ref)


def test_no_windows_gives_an_empty_tensor(allsky):
    tropo, play, tlay, cg, h2o = _cells(allsky, allsky.gas_lw, "fused")
    empty = torch.zeros((0, 5), dtype=torch.int32)
    n0 = ms.minor_scale.launches
    for fn in (ms.minor_scale, ms.minor_scale_plain):
        got = fn(tropo, play, tlay, cg, h2o, (), empty)
        assert tuple(got.shape) == (0,) + tuple(play.shape)
        assert got.dtype == play.dtype
    assert ms.minor_scale.launches == n0
    g = play.new_zeros((0,) + tuple(play.shape))
    dcol, dp, dt = ms.minor_scale_bwd_plain(tropo, play, tlay, cg, h2o, (),
                                            empty, g)
    assert not dcol.any() and not dp.any() and not dt.any()


@pytest.mark.parametrize("layout", ["fused", "public"])
@pytest.mark.parametrize("band", ["lw", "sw"])
def test_closed_form_adjoint_matches_autograd(allsky64, band, layout):
    gas = getattr(allsky64, "gas_" + band)
    tropo, play, tlay, cg, h2o = _cells(allsky64, gas, layout)
    gen = torch.Generator().manual_seed(11)
    g = torch.randn((len(gas.minor_windows),) + tuple(play.shape),
                    generator=gen, dtype=torch.float64)
    x = [t.detach().clone().requires_grad_() for t in (cg, play, tlay)]
    rows = ms.minor_scale_plain(tropo, x[1], x[2], x[0], h2o,
                                gas.minor_windows)
    want = torch.autograd.grad(rows, x, g)
    got = ms.minor_scale_bwd_plain(tropo, play, tlay, cg, h2o,
                                   gas.minor_windows, None, g)
    for name, a, b in zip(("col_gas", "play", "tlay"), got, want):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-12 * scale, name
    # every col_gas row no window reads has a zero cotangent
    read = {0, h2o} | {w[1] for w in gas.minor_windows} | {
        w[3] for w in gas.minor_windows if w[2] and w[3] > 0}
    for k in range(cg.shape[0]):
        if k not in read:
            assert not got[0][k].any()


def _small(seed=5, shape=(3, 4), ngas=5):
    """Cells with every value of order 1, for finite differences."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.rand(s, generator=gen, dtype=torch.float64)
    tropo = rnd(*shape) > 0.4
    play = 50.0 + 100.0 * rnd(*shape)
    tlay = 200.0 + 100.0 * rnd(*shape)
    cg = 0.5 + rnd(ngas + 1, *shape)
    windows = ((1, 1, 1, 1, 0), (1, 2, 1, 1, 1), (1, 3, 0, -1, 0),
               (1, 4, 1, 0, 0), (1, 1, 1, 5, 1), (0, 2, 1, 3, 0),
               (0, 5, 0, -1, 0), (0, 1, 1, 1, 1), (0, 4, 1, -1, 0))
    return tropo, play, tlay, cg, 1, windows, torch.as_tensor(
        windows, dtype=torch.int32)


@pytest.mark.parametrize("route", ["twin", "adjoint"])
def test_gradcheck_through_the_node(monkeypatch, route):
    """float64 gradcheck of ``minor_scale`` in play, tlay and col_gas: the
    backward of CPU tensors (the twin's autograd) and, with the node's
    dispatch told the tensors are on the card, the adjoint route (the
    closed form through ``with_adjoint``'s cotangent layout)."""
    if route == "adjoint":
        monkeypatch.setattr(autodiff, "on_cpu", lambda t, what: False)
    tropo, play, tlay, cg, h2o, windows, table = _small()
    f = lambda p, t, c: ms.minor_scale(tropo, p, t, c, h2o, windows, table)
    args = tuple(x.clone().requires_grad_() for x in (play, tlay, cg))
    assert torch.autograd.gradcheck(f, args)


class _Card:
    """The launcher on CPU tensors: records each call and fills the
    outputs from the twins, so a step runs the wrapper's CUDA branch."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, fn, what, *a):
        assert name == "minor_scale"
        self.calls.append((fn, a))
        tropo, play, tlay, col, table = a[0], a[3], a[6], a[9], a[13]
        windows = tuple(tuple(w) for w in table.tolist())
        h2o = a[15]
        if fn == "launch_minor_scale":
            a[-1].copy_(ms.minor_scale_plain(tropo, play, tlay, col, h2o,
                                             windows))
            return
        g = a[20]
        outs = (a[21], a[25], a[28])
        for o, v in zip(outs, ms.minor_scale_bwd_plain(
                tropo, play, tlay, col, h2o, windows, table, g)):
            o.copy_(v)


@pytest.fixture
def card(monkeypatch):
    rec = _Card()
    monkeypatch.setattr(ms, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(ms, "launch", rec)
    return rec


def _fused(p, x):
    lw = allsky_step_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
    sw = allsky_step_sw(x, p.gas_sw, cloud_optics=p.cld_sw)
    return lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir


def _api(p, x):
    lw = allsky_api_lw(x, p.gas_lw, cloud_optics=p.cld_lw)
    sw = allsky_api_sw(x, p.gas_sw, cloud_optics=p.cld_sw)
    return lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn, sw.flux_dn_dir


@pytest.mark.parametrize("path", ["fused", "api"])
def test_cuda_branch_one_launch_per_call(allsky, card, path):
    step = {"fused": _fused, "api": _api}[path]
    x = allsky.inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ms, "on_cpu", lambda t, what: True)
        ref = step(allsky, x)
    with trace.collect() as rec:
        got = step(allsky, x)
    assert rec.counters["launches.minor_scale"] == 2
    assert rec.counters["launches.minor_scale_bwd"] == 0
    assert [fn for fn, _ in card.calls] == ["launch_minor_scale"] * 2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    inp = x
    for (_, a), gas in zip(card.calls, (allsky.gas_lw, allsky.gas_sw)):
        tropo, play, tlay, col, table = a[0], a[3], a[6], a[9], a[13]
        # the caller's own tensors, strides and the table: nothing copied
        assert table is gas.minor_scale_table
        assert play.data_ptr() == inp.play.data_ptr()
        assert tlay.data_ptr() == inp.tlay.data_ptr()
        assert a[1:3] == tropo.stride() and a[4:6] == play.stride()
        assert a[7:9] == tlay.stride() and a[10:13] == col.stride()
        assert a[14] == len(gas.minor_windows)
        if path == "fused":
            # play a layer-major view; col_gas the descriptors kernel's
            # contiguous layer-major output
            assert play.stride() == (1, NLAY)
            assert col.is_contiguous() and col.shape[1:] == (NLAY, NCOL)
    names = {(r[0], r[2]) for r in rec.spans}
    assert ("kernel.minor_scale", "gas.minor_scaling") in names


def test_cuda_branch_gradient_step(allsky, card, monkeypatch):
    """The fused step's gradient in tlay and the water vapour with the
    rows' node on its adjoint route: one adjoint launch per gas-optics
    call, the gradients those of the twins' autograd (the closed form is
    exact algebra of the twin: equal to rounding)."""
    # the rows' node alone (its first tensor, tropo, is the only bool one)
    # takes its adjoint; the other nodes keep their CPU backward
    monkeypatch.setattr(autodiff, "on_cpu", lambda t, what: not (
        what == "backward" and t.dtype == torch.bool))
    x = allsky.inputs

    def grads():
        tlay = x.tlay.detach().clone().requires_grad_()
        h2o = x.gas_concs.get_vmr("h2o", NCOL, NLAY).detach().clone()
        h2o.requires_grad_()
        y = x._replace(tlay=tlay, gas_concs=x.gas_concs.set_vmr("h2o", h2o))
        loss = sum((w * f).sum() for w, f in zip((1.0, 0.5, 0.3, 0.2, 0.1),
                                                  _fused(allsky, y)))
        return torch.autograd.grad(loss, (tlay, h2o))

    with trace.collect() as rec:
        got = grads()
    assert rec.counters["launches.minor_scale"] == 2
    assert rec.counters["launches.minor_scale_bwd"] == 2
    names = {(r[0], r[2]) for r in rec.spans}
    assert ("backward.minor_scale", None) in names
    monkeypatch.setattr(ms, "on_cpu", lambda t, what: True)
    monkeypatch.setattr(autodiff, "on_cpu", lambda t, what: True)
    want = grads()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
