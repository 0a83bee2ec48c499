"""The gas-optics descriptors of one call in one kernel launch
(``ops/kernels/gas_descriptors.py``, ``csrc/gas_descriptors.cu``), on the
CPU.

  * On CPU tensors the wrapper is the twin: col_gas and the interpolation
    coefficients equal the column amounts and interpolation as the port
    formed them before the kernel (copied below: vmrs broadcast to fields,
    the tables copied from the host per call), indices equal and floats
    within 1e-12 in float64, on the oracle k-distribution of
    tests/rrtmgp_synthetic.py and on the all-sky configuration, in both
    layouts (contiguous), with every gas a field, with fields, profiles
    and scalars mixed (float32 and float64), and with a given col_dry.
  * The adjoint's closed form (the CUDA adjoint's arithmetic) equals
    autograd of the twin in float64 for every differentiable input (play,
    tlay, plev, col_dry, field, profile and scalar vmrs), in both layouts;
    ``gradcheck`` passes through the autograd node, on the twin's backward
    and on the adjoint's.
  * The tables are made once, when the gas optics are built: a call makes
    none.
  * The CUDA branch, taken here on CPU tensors with the launcher replaced
    by an emulation that reads the launch's arguments as the kernel does
    (each gas through its pointer, kind and strides) and fills the outputs
    from the twins: one launch per gas-optics call on the caller's own
    tensors, the k-distribution's tables and the layout asked, so 2 a
    fused all-sky step and 2 a public-API step, the outputs those of the
    step on the twins bit for bit; 2 adjoint launches a gradient step, the
    gradients those of the twins' autograd.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rrtmgp_synthetic import GASES, sample_atmosphere, synthetic_raw  # noqa: E402
from rte_rrtmgp_tpu_torch import constants, trace  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_api_lw, allsky_api_sw, allsky_step_lw, allsky_step_sw,
    build_allsky)
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp import gas_optics as go  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist  # noqa: E402
from rte_rrtmgp_tpu_torch.ops import gas_optics as ops_go  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import autodiff  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels import gas_descriptors as gd  # noqa: E402

F64 = torch.float64
NCOL, NLAY = 24, 9
RTOL = 1e-12
INDICES = ("jtemp", "jpress", "tropo", "jeta")
FRACTIONS = ("ftemp", "fpress", "col_mix", "feta")


# ---------------------------------------------------------------------------
# the column amounts and the interpolation as the port formed them before
# the kernel (each call copying its tables from the host)
# ---------------------------------------------------------------------------
def _old_col_gas(kd, play, plev, gas_concs, col_dry=None):
    ncol, nlay = play.shape
    vmrs = [gas_concs.get_vmr(g, ncol, nlay).to(play.dtype)
            if g in gas_concs else torch.zeros_like(play)
            for g in kd.gas_names]
    idx_h2o = kd.idx_gas("h2o")
    if col_dry is None:
        vmr_h2o = (vmrs[idx_h2o - 1] if idx_h2o > 0
                   else torch.zeros_like(play))
        col_dry = ops_go.get_col_dry(vmr_h2o, plev)
    col_dry = torch.as_tensor(col_dry, dtype=play.dtype, device=play.device)
    if idx_h2o < 0:
        vmrs = vmrs + [torch.zeros_like(play)]
        idx_h2o = len(vmrs)
    return torch.stack([col_dry] + [v * col_dry for v in vmrs]), idx_h2o


def _old_interpolation(kd, play, tlay, col_gas):
    dtype, dev = play.dtype, play.device
    temp_ref = np.asarray(kd.temp_ref)
    ntemp, npres, neta = temp_ref.shape[0], kd.press_ref_log.shape[0], kd.neta
    loctemp = (tlay - (kd.temp_ref_min - kd.temp_ref_delta)) \
        / kd.temp_ref_delta
    jtemp1 = torch.clamp(torch.floor(loctemp).to(torch.int32), 1, ntemp - 1)
    temp_ref_t = torch.as_tensor(temp_ref, dtype=dtype, device=dev)
    ftemp = (tlay - temp_ref_t[jtemp1.long() - 1]) / kd.temp_ref_delta
    jtemp = jtemp1 - 1
    locpress = 1.0 + (torch.log(play) - float(kd.press_ref_log[0])) \
        / kd.press_ref_log_delta
    jpress_f = torch.clamp(torch.trunc(locpress), 1.0, float(npres - 1))
    fpress = locpress - jpress_f
    jpress = jpress_f.to(torch.int32) - 1
    tropo = play > torch.exp(torch.tensor(kd.press_ref_trop_log,
                                          dtype=dtype))
    g1, g2 = np.asarray(kd.flavor[0]), np.asarray(kd.flavor[1])
    vmr_ref = np.asarray(kd.vmr_ref)
    ratio = torch.as_tensor(vmr_ref[:, g1, :] / vmr_ref[:, g2, :],
                            dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny
    cg1 = col_gas[torch.as_tensor(g1, device=dev)]
    cg2 = col_gas[torch.as_tensor(g2, device=dev)]
    cms, jes, fes = [], [], []
    for it in (0, 1):
        jt_i = torch.clamp(jtemp + it, 0, ntemp - 1).long()
        r = torch.where(tropo, ratio[0][:, jt_i], ratio[1][:, jt_i])
        cm = cg1 + r * cg2
        big = cm > 2.0 * tiny
        eta = torch.where(big, cg1 / torch.where(big, cm, 1.0), 0.5)
        loceta = eta * (neta - 1)
        trunc_loceta = torch.trunc(loceta)
        jes.append(torch.clamp(trunc_loceta.to(torch.int32) + 1,
                               max=neta - 1) - 1)
        fes.append(loceta - trunc_loceta)
        cms.append(cm)
    return ops_go.InterpCoeffs(jtemp, ftemp, jpress, fpress, tropo,
                               torch.stack(jes), torch.stack(cms),
                               torch.stack(fes))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
def _oracle(sw):
    gas = go.GasOpticsRRTMGP(KDist.from_raw(GASES, dtype=F64, device="cpu",
                                            **synthetic_raw(sw=sw)))
    play, plev, tlay, _, _, vmr = sample_atmosphere(ncol=4, nlay=9)
    gc = GasConcs.empty()
    for k, v in vmr.items():
        gc = gc.set_vmr(k, v)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    return gas, t(play), t(plev), t(tlay), gc


@pytest.fixture(scope="module")
def allsky64():
    return build_allsky(NCOL, NLAY, 32, 4, 28, 4, 5, 9, device="cpu",
                        dtype=F64)


@pytest.fixture(scope="module")
def allsky():
    return build_allsky(NCOL, NLAY, 32, 4, 28, 4, 5, 9, device="cpu")


def _case(name, allsky64):
    if name.startswith("oracle"):
        return _oracle(sw=name.endswith("sw"))
    inp = allsky64.inputs
    gas = allsky64.gas_lw if name.endswith("lw") else allsky64.gas_sw
    return gas, inp.play, inp.plev, inp.tlay, inp.gas_concs


def _kinds(gc, ncol, nlay, kinds):
    """``gc`` with its gases as the kinds asked: ``fields`` every gas an
    (ncol, nlay) field; ``mixed`` the first gas a field, the second a
    profile (its first column), the third a float64 scalar, the fourth a
    float32 field, the rest as stored."""
    if kinds == "stored":
        return gc
    out = GasConcs.empty()
    for i, name in enumerate(gc.names):
        v = gc.get_vmr(name, ncol, nlay)
        if kinds == "mixed":
            v = (v.clone(), v[0].clone(), v[0, 0].clone(),
                 v.float().clone(), v)[min(i, 4)]
        out = out.set_vmr(name, v.clone() if kinds == "fields" else v)
    return out


CASES = ("oracle-lw", "oracle-sw", "allsky-lw", "allsky-sw")


@pytest.mark.parametrize("col_dry", ["computed", "given"])
@pytest.mark.parametrize("kinds", ["stored", "fields", "mixed"])
@pytest.mark.parametrize("layout", ["public", "fused"])
@pytest.mark.parametrize("case", CASES)
def test_cpu_wrapper_equals_col_gas_and_interpolation(allsky64, case, layout,
                                                      kinds, col_dry):
    gas, play, plev, tlay, gc = _case(case, allsky64)
    kd = gas.kdist
    gc = _kinds(gc, *play.shape, kinds)
    dry = None
    if col_dry == "given":
        dry = 1.01 * ops_go.get_col_dry(
            gc.get_vmr("h2o", *play.shape).to(F64), plev)
    old_cg, old_h2o = _old_col_gas(kd, play, plev, gc, dry)
    old_co = _old_interpolation(kd, play, tlay, old_cg)
    n0 = (gd.gas_descriptors.launches, gd.gas_descriptors_bwd.launches)
    vmrs, h2o = go.vmr_rows(gas.kdist, gc, *play.shape)
    fused = layout == "fused"
    cg, co = gd.gas_descriptors(play, tlay, plev, vmrs, dry, h2o,
                                gas.interp_tables[F64], fused)
    assert (gd.gas_descriptors.launches,
            gd.gas_descriptors_bwd.launches) == n0
    assert h2o == old_h2o
    lay = (lambda x: x.transpose(-1, -2)) if fused else (lambda x: x)
    assert cg.is_contiguous() and cg.shape == lay(old_cg).shape
    np.testing.assert_allclose(cg.numpy(), lay(old_cg).numpy(), rtol=RTOL)
    for name in INDICES + FRACTIONS:
        got, ref = getattr(co, name), lay(getattr(old_co, name))
        assert got.is_contiguous() and got.shape == ref.shape, name
        assert got.dtype == ref.dtype, name
        if name in INDICES:
            assert torch.equal(got, ref), name
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                                       atol=1e-15, err_msg=name)
    # the gas optics' plain twins give the same
    tw_cg, tw_dry, tw_h2o = gas.col_gas(play, plev, gc, dry)
    assert torch.equal(lay(tw_cg).contiguous(), cg) and tw_h2o == h2o
    assert torch.equal(tw_dry, tw_cg[0])
    tw_co = gas.interp(play, tlay, tw_cg)
    for a, b in zip(tw_co, co):
        assert torch.equal(lay(a).contiguous(), b)


def _leaves(play, plev, tlay, gc, col_dry):
    """Fresh float64 leaves: play, tlay, plev, col_dry (or None) and the
    vmrs (a field, a profile, a scalar, the rest as stored)."""
    mixed = _kinds(gc, *play.shape, "mixed")
    gas_v = [mixed.stored_vmr(n, *play.shape).to(F64).detach().clone()
             for n in mixed.names]
    return mixed, [t.detach().clone().requires_grad_() for t in
                   (play, tlay, plev)] + [
        None if col_dry is None else col_dry.clone().requires_grad_()], [
        v.requires_grad_() for v in gas_v]


@pytest.mark.parametrize("col_dry", ["computed", "given"])
@pytest.mark.parametrize("layout", ["public", "fused"])
@pytest.mark.parametrize("case", CASES)
def test_closed_form_adjoint_matches_autograd(allsky64, case, layout,
                                              col_dry):
    gas, play, plev, tlay, gc = _case(case, allsky64)
    dry = (None if col_dry == "computed" else ops_go.get_col_dry(
        gc.get_vmr("h2o", *play.shape).to(F64), plev))
    mixed, (p, t, pl, cd), vs = _leaves(play, plev, tlay, gc, dry)
    store = GasConcs(names=mixed.names, values=tuple(vs))
    vmrs, h2o = go.vmr_rows(gas.kdist, store, *play.shape)
    tables, fused = gas.interp_tables[F64], layout == "fused"
    cg, co = gd.gas_descriptors_plain(p, t, pl, vmrs, cd, h2o, tables, fused)
    outs = (cg, co.ftemp, co.fpress, co.col_mix, co.feta)
    gen = torch.Generator().manual_seed(7)
    g = tuple(torch.randn(o.shape, generator=gen, dtype=F64) for o in outs)
    wrt = [x for x in (p, t, pl, cd) if x is not None] + [
        v for v in vmrs if v is not None]
    want = torch.autograd.grad(outs, wrt, g, allow_unused=True)
    dplay, dtlay, dplev, dcd, dv = gd.gas_descriptors_bwd_plain(
        play, tlay, plev, tuple(None if v is None else v.detach()
                                for v in vmrs), dry, h2o, tables, fused, g)
    assert (dplev is None) == (dry is not None)
    assert (dcd is None) == (dry is None)
    got = [dplay, dtlay, dplev] + ([] if dry is None else [dcd]) + [
        d for d in dv if d is not None]
    assert len(got) == len(want)
    for a, b, x in zip(got, want, wrt):
        a = torch.zeros_like(x) if a is None else a
        b = torch.zeros_like(x) if b is None else b
        assert a.shape == x.shape and a.dtype == x.dtype
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * max(scale, 1e-300)


def _small(seed=3):
    """Cells with order-one values inside the tables' ranges, for finite
    differences: (ncol, nlay) = (3, 4)."""
    gas = go.GasOpticsRRTMGP(KDist.from_raw(GASES, dtype=F64, device="cpu",
                                            **synthetic_raw()))
    play, plev, tlay, _, _, vmr = sample_atmosphere(ncol=3, nlay=4,
                                                    seed=seed)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    vmrs = (t(vmr["h2o"]), t(vmr["o3"][0] * 1e3), t(0.3), t(vmr["o3"]))
    return gas, t(play), t(plev), t(tlay), vmrs


@pytest.mark.parametrize("col_dry", ["computed", "given"])
@pytest.mark.parametrize("route", ["twin", "adjoint"])
def test_gradcheck_through_the_node(monkeypatch, route, col_dry):
    """float64 gradcheck of ``gas_descriptors`` in play, tlay, plev (or a
    given col_dry) and the vmrs (a field, a profile, a scalar, a field):
    the backward of CPU tensors (the twin's autograd) and, with the node's
    dispatch told the tensors are on the card, the adjoint route (the
    closed form through ``with_adjoint``'s cotangent layout)."""
    if route == "adjoint":
        monkeypatch.setattr(autodiff, "on_cpu", lambda t, what: False)
    gas, play, plev, tlay, vmrs = _small()
    kd = gas.kdist
    names = [kd.gas_names.index(n) for n in ("h2o", "co2", "o3", "n2o")]
    tables = gas.interp_tables[F64]
    h2o = kd.idx_gas("h2o")
    dry = ops_go.get_col_dry(vmrs[0], plev) if col_dry == "given" else None

    def f(p, t, pl, cd, *v):
        full = [None] * len(kd.gas_names)
        for i, x in zip(names, v):
            full[i] = x
        cg, co = gd.gas_descriptors(p, t, pl, full, cd, h2o, tables, True)
        # the columns (molecules per cm2) scaled to order one
        return cg * 1e-24, co.ftemp, co.fpress, co.col_mix * 1e-24, co.feta

    args = tuple(x if x is None else x.clone().requires_grad_()
                 for x in (play, tlay, plev, dry, *vmrs))
    if dry is None:
        g = lambda p, t, pl, *v: f(p, t, pl, None, *v)
        args = args[:3] + args[4:]
    else:
        g = lambda p, t, cd, *v: f(p, t, plev, cd, *v)
        args = args[:2] + args[3:]
    assert torch.autograd.gradcheck(g, args, eps=1e-7, atol=1e-6,
                                    rtol=1e-5)


def test_tables_are_made_once(allsky, monkeypatch):
    """Each dtype's tables are made when the gas optics are built, on the
    k-distribution's device; steps make none."""
    for gas in (allsky.gas_lw, allsky.gas_sw):
        kd = gas.kdist
        assert set(gas.interp_tables) == {torch.float32, torch.float64}
        for dt, t in gas.interp_tables.items():
            assert t.temp_ref.dtype == t.vmr_ratio.dtype == dt
            assert t.temp_ref.device == t.vmr_ratio.device == t.flavor.device
            assert t.temp_ref.device == kd.kmajor.device
            assert tuple(t.flavor.shape) == (2, kd.nflav)
            assert t.flavor.tolist() == np.asarray(kd.flavor).tolist()
    before = {id(g): {dt: (t.temp_ref.data_ptr(), t.vmr_ratio.data_ptr(),
                           t.flavor.data_ptr())
                      for dt, t in g.interp_tables.items()}
              for g in (allsky.gas_lw, allsky.gas_sw)}
    made = []
    monkeypatch.setattr(go, "interp_tables",
                        lambda *a: made.append(a) or ops_go.interp_tables(*a))
    for _ in range(2):
        _fused(allsky, allsky.inputs)
        _api(allsky, allsky.inputs)
    assert made == []
    for g in (allsky.gas_lw, allsky.gas_sw):
        assert {dt: (t.temp_ref.data_ptr(), t.vmr_ratio.data_ptr(),
                     t.flavor.data_ptr())
                for dt, t in g.interp_tables.items()} == before[id(g)]


# ---------------------------------------------------------------------------
# the CUDA branch on CPU tensors
# ---------------------------------------------------------------------------
def _at(ptr, dtype, shape, strides):
    """The memory a kernel reads at ``ptr`` through ``strides``."""
    n = 1 + sum((s - 1) * x for s, x in zip(shape, strides))
    ct = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    buf = torch.frombuffer((ct * n).from_address(ptr), dtype=dtype)
    return torch.as_strided(buf, shape, strides)


class _Card:
    """The launcher on CPU tensors: records each call, reads each gas as
    the kernel does (pointer, kind, strides or host value) and fills the
    outputs from the twins, so a step runs the wrapper's CUDA branch."""

    def __init__(self, gases):
        self.calls = []
        self.tables = {t.temp_ref.data_ptr(): t for g in gases
                       for t in g.interp_tables.values()}

    def vmrs(self, a):
        ptrs, kinds, strides, values, n = a[:5]
        shape = (a[24], a[25])
        out = []
        for k in range(n):
            if kinds[k] == 0:
                out.append(None)
            elif kinds[k] == 3:
                out.append(torch.tensor(values[k], dtype=F64))
            else:
                dt = torch.float32 if kinds[k] == 1 else F64
                out.append(_at(ptrs[k], dt, shape,
                               (strides[2 * k], strides[2 * k + 1])))
        return out

    def __call__(self, name, fn, what, *a):
        assert name == "gas_descriptors"
        self.calls.append((fn, a))
        play, tlay, plev, col_dry = a[5], a[8], a[11], a[14]
        tables = self.tables[a[17].data_ptr()]
        assert a[18] is tables.vmr_ratio and a[19] is tables.flavor
        h2o, lm = a[23], bool(a[26])
        vmrs = self.vmrs(a)
        lay = (lambda x: x.transpose(-1, -2)) if lm else (lambda x: x)
        if fn == "launch_gas_descriptors":
            cg, co = gd.gas_descriptors_plain(play, tlay, plev, vmrs,
                                              col_dry, h2o, tables, lm)
            for o, v in zip(a[29:38], (cg, *co)):
                o.copy_(v)
            return
        g = tuple(lay(x) for x in a[29:34])
        dplay, dtlay, dthick, dcd, dv = gd.cell_cotangents(
            play, tlay, plev, vmrs, col_dry, h2o, tables, g)
        for o, v in ((a[34], dplay), (a[35], dtlay), (a[36], dcd),
                     (a[37], dthick)):
            if o is not None:
                lay(o).copy_(v)
        slot = a[39]
        for k in range(a[4]):
            if slot[k] >= 0:
                lay(a[38][slot[k]]).copy_(dv[k])


@pytest.fixture
def card(monkeypatch, allsky):
    rec = _Card((allsky.gas_lw, allsky.gas_sw))
    monkeypatch.setattr(gd, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(gd, "launch", rec)
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
        mp.setattr(gd, "on_cpu", lambda t, what: True)
        ref = step(allsky, x)
    with trace.collect() as rec:
        got = step(allsky, x)
    assert rec.counters["launches.gas_descriptors"] == 2
    assert rec.counters["launches.gas_descriptors_bwd"] == 0
    assert rec.counters["waits"] == (1 if path == "fused" else 11)
    assert [fn for fn, _ in card.calls] == ["launch_gas_descriptors"] * 2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for (_, a), gas in zip(card.calls, (allsky.gas_lw, allsky.gas_sw)):
        kd = gas.kdist
        # the caller's own tensors and strides, the tables, the layout
        assert a[5].data_ptr() == x.play.data_ptr()
        assert a[6:8] == x.play.stride()
        assert a[8].data_ptr() == x.tlay.data_ptr()
        assert a[11].data_ptr() == x.plev.data_ptr() and a[14] is None
        assert a[17] is gas.interp_tables[torch.float32].temp_ref
        assert a[4] == len(kd.gas_names) and a[23] == kd.idx_gas("h2o")
        assert (a[24], a[25]) == (NCOL, NLAY)
        assert a[26] == (path == "fused") and a[27] == 0
        consts = list(a[28])
        assert consts[1] == float(np.float32(1) /
                                  np.float32(kd.temp_ref_delta))
        assert consts[8:] == [constants.m_h2o, constants.m_dry,
                              constants.avogad, constants.grav]
        # a device gas is read in place, through its strides
        for k, name in enumerate(kd.gas_names):
            if name in x.gas_concs:
                v = x.gas_concs.stored_vmr(name, NCOL, NLAY)
                assert a[0][k] == v.data_ptr() and a[1][k] == 1
            else:
                assert a[1][k] == 0
        cells = (NLAY, NCOL) if path == "fused" else (NCOL, NLAY)
        assert all(o.is_contiguous() and o.shape[-2:] == cells
                   for o in a[29:38])
    names = {(r[0], r[2]) for r in rec.spans}
    assert ("kernel.gas_descriptors", "gas.descriptors") in names
    # no host copy or wait; the twins run only inside the emulated launch
    assert not any(r[0].startswith("wait.interp") for r in rec.spans)
    assert all(r[2] == "kernel.gas_descriptors" for r in rec.spans
               if r[0] in ("gas.col_gas", "gas.interp"))


def test_cuda_branch_reads_each_gas_kind(allsky, card):
    """Fields, a profile, a float64 scalar and a float32 field, read by
    pointer, kind and strides (a profile's column stride and a scalar's
    both strides 0); the outputs those of the twins, bit for bit."""
    x = allsky.inputs
    gas = allsky.gas_lw
    mixed = _kinds(x.gas_concs, NCOL, NLAY, "mixed")
    vmrs, h2o = go.vmr_rows(gas.kdist, mixed, NCOL, NLAY)
    t = gas.interp_tables[torch.float32]
    got = gd.gas_descriptors(x.play, x.tlay, x.plev, vmrs, None, h2o, t,
                             True)
    ref = gd.gas_descriptors_plain(x.play, x.tlay, x.plev, vmrs, None, h2o,
                                   t, True)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    (_, a), = card.calls
    for k, v in enumerate(vmrs):
        if v is None:
            assert a[1][k] == 0
            continue
        want = (v.stride() if v.ndim == 2 else (0, v.stride(0)) if v.ndim
                else (0, 0))
        assert a[1][k] == (1 if v.dtype == torch.float32 else 2)
        assert (a[2][2 * k], a[2][2 * k + 1]) == want


def test_cuda_branch_refuses_mixed_dtypes(allsky, card):
    x = allsky.inputs
    gas = allsky.gas_lw
    vmrs, h2o = go.vmr_rows(gas.kdist, x.gas_concs, NCOL, NLAY)
    with pytest.raises(ValueError, match="tlay"):
        gd.gas_descriptors(x.play, x.tlay.double(), x.plev, vmrs, None, h2o,
                           gas.interp_tables[torch.float32], True)
    assert card.calls == []


def test_cuda_branch_gradient_step(allsky, card, monkeypatch):
    """The fused step's gradient in tlay and the water vapour with the
    descriptors' node on its adjoint route: one adjoint launch per
    gas-optics call, the gradients those of the twins' autograd."""
    x = allsky.inputs
    # the descriptors' node alone (its first tensor is play) takes its
    # adjoint; the other nodes keep their CPU backward
    monkeypatch.setattr(autodiff, "on_cpu", lambda t, what: not (
        what == "backward" and t.data_ptr() == x.play.data_ptr()))

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
    assert rec.counters["launches.gas_descriptors"] == 2
    assert rec.counters["launches.gas_descriptors_bwd"] == 2
    assert [fn for fn, _ in card.calls] == (["launch_gas_descriptors"] * 2
                                            + ["launch_gas_descriptors_bwd"]
                                            * 2)
    for _, a in card.calls[2:]:
        # play and tlay always; h2o's plane; no col_dry, no levels
        assert a[36] is None and a[37] is None
        assert a[38].shape[0] == 1
        assert [a[39][k] for k in range(a[4])].count(0) == 1
    names = {(r[0], r[2]) for r in rec.spans}
    assert ("backward.gas_descriptors", None) in names
    monkeypatch.setattr(gd, "on_cpu", lambda t, what: True)
    monkeypatch.setattr(autodiff, "on_cpu", lambda t, what: True)
    want = grads()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
