"""The Python side of the fused adjoint kernels' per-cell sums, on the CPU.

``ops/kernels/adjoint_segments.py`` builds the tables with which the
fused adjoints (``csrc/fused_lw_bwd.cu``, ``csrc/fused_sw_bwd.cu``) sum
each cell's descriptor cotangents over g-points: segmented warp scans over
runs of g-points, then fixed lists of runs per output. Here the kernels'
algorithm is replayed in numpy (the Hillis-Steele scan of
``gas_optics_bwd.cuh::seg_scan`` per 32-lane warp, the run sums at the
runs' last lanes, the lists per output) on random terms, and held in
float64 against sums read directly from gpt2band, gflav and the minor
windows: the flagship widths (16-wide bands), the non-banded ones (12-wide
bands at 192 / 168 g-points), a ragged and a reordered band layout, and
minor windows that cross a multiple of 32. Also the adjoints' scratch
sizes at 4096 x 72 against the bytes PERF.md states, and the port's
counterpart of tests/test_r5_regressions.py:284 (a k-distribution without
h2o gets a zero h2o column), held against the JAX package.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.gas_concs import GasConcs as JaxGasConcs  # noqa: E402
from rte_rrtmgp_tpu.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP as JaxGasOptics)
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import (  # noqa: E402
    GasOpticsRRTMGP)
from rte_rrtmgp_tpu_torch.ops.kernels.adjoint_segments import (  # noqa: E402
    HEADER, WARP, build_segments, segments_on)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    lw_fused_bwd_scratch_bytes)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused_bwd_scratch_bytes)
from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw_bwd import (  # noqa: E402
    sw_2stream_bwd_scratch_bytes)
from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist  # noqa: E402


def _decode(seg, nflav, nminor):
    """The table's fields by name."""
    t = seg.table
    nslot, nrb, nrm, span_b, span_m, nband, threads, csr_len = t[:HEADER]
    pt = t[HEADER:HEADER + (1 + 2 * nslot) * threads].reshape(-1, threads)
    csr = t[HEADER + (1 + 2 * nslot) * threads:]
    assert csr.size == csr_len
    lists, at = {}, 0
    for name, n in (("band", nband), ("flav0", nflav), ("flav1", nflav),
                    ("mflav", nflav), ("minor", nminor)):
        first = csr[at:at + n + 1]
        lists[name] = [csr[first[i]:first[i + 1]] for i in range(n)]
        at += n + 1
    return dict(nslot=nslot, nrb=nrb, nrm=nrm, span_b=span_b, span_m=span_m,
                nband=nband, threads=threads, band_code=pt[0],
                slot_code=pt[1::2], slot_minor=pt[2::2], lists=lists)


def _scan(v, code, span):
    """seg_scan over every warp at once, then the run sums at their last
    lanes: {run: sum}."""
    back = code & 31
    v = v.copy()
    off = 1
    while off < span:
        w = v.reshape(-1, WARP)
        up = np.concatenate([w[:, :off], w[:, :-off]], axis=1).reshape(-1)
        v = np.where(off <= back, v + up, v)
        off <<= 1
    return {int(c >> 5) - 1: v[g] for g, c in enumerate(code) if c >> 5}


def _replay(seg, nflav, nminor, band_terms, minor_terms):
    """The kernel's sums of one cell: band_terms (ngpt,) summed by band
    and by flavor in each atmosphere; minor_terms {(m, g): value} summed
    by minor and by the minors' flavor."""
    d = _decode(seg, nflav, nminor)
    T = d["threads"]
    vb = np.zeros(T)
    vb[:band_terms.size] = band_terms
    pb = _scan(vb, d["band_code"], d["span_b"])
    assert sorted(pb) == list(range(d["nrb"]))
    pm = {}
    for k in range(d["nslot"]):
        vm = np.array([minor_terms.get((int(m), g), 0.0) if m >= 0 else 0.0
                       for g, m in enumerate(d["slot_minor"][k])])
        pm.update(_scan(vm, d["slot_code"][k], d["span_m"]))
    assert sorted(pm) == list(range(d["nrm"]))
    L = d["lists"]
    return dict(
        band=[sum(pb[r] for r in L["band"][b]) for b in range(d["nband"])],
        flav=[[sum(pb[r] for r in L[f"flav{a}"][f]) for f in range(nflav)]
              for a in range(2)],
        mflav=[sum(pm[r] for r in L["mflav"][f]) for f in range(nflav)],
        minor=[sum(pm[r] for r in L["minor"][m]) for m in range(nminor)])


def _check(gpt2band, gflav, minors, nflav, seed=0):
    """The replayed sums against direct sums over gpt2band, gflav and the
    minor windows; the runs stay inside warps."""
    g2b = np.asarray(gpt2band)
    gfl = np.asarray(gflav).reshape(2, -1)
    ngpt, nminor = g2b.size, len(minors)
    seg = build_segments(g2b, gfl, minors, nflav)
    d = _decode(seg, nflav, nminor)
    for code in (d["band_code"],) + tuple(d["slot_code"]):
        back = code & 31
        assert np.all(back <= np.arange(d["threads"]) % WARP)
    rng = np.random.default_rng(seed)
    band_terms = rng.uniform(-1.0, 1.0, ngpt)
    minor_terms = {(m, g): rng.uniform(-1.0, 1.0)
                   for m, (_, _, g0, w, _) in enumerate(minors)
                   for g in range(g0, g0 + w)}
    got = _replay(seg, nflav, nminor, band_terms, minor_terms)
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-12,
                                                    atol=1e-12)
    close(got["band"], [band_terms[g2b == b].sum()
                        for b in range(g2b.max() + 1)])
    for a in range(2):
        close(got["flav"][a], [band_terms[gfl[a] == f].sum()
                               for f in range(nflav)])
    close(got["minor"], [sum(v for (mm, _), v in minor_terms.items()
                             if mm == m) for m in range(nminor)])
    close(got["mflav"], [sum(v for (mm, _), v in minor_terms.items()
                             if minors[mm][1] == f) for f in range(nflav)])
    return seg


def _kdist_case(sw, **kw):
    gas = GasOpticsRRTMGP(synthetic_kdist(sw=sw, device="cpu", **kw))
    return (gas.gpt2band.numpy(), gas.gpoint_flavor.numpy(), gas.minors,
            gas.kdist.flavor.shape[1])


@pytest.mark.parametrize("case", [
    "lw flagship", "sw flagship", "lw non-banded", "sw non-banded"])
def test_segments_of_the_paths_kdists(case):
    """The synthetic k-distributions of the main path (LW 256 g-points /
    16 bands, SW 224 / 14) and of the non-banded configuration (192 / 16,
    168 / 14: 12-wide bands, bands and minor windows across warps)."""
    sw = case.startswith("sw")
    kw = ({} if "flagship" in case
          else dict(ngpt=168 if sw else 192, nbnd=14 if sw else 16))
    g2b, gfl, minors, nflav = _kdist_case(sw, **kw)
    seg = _check(g2b, gfl, minors, nflav)
    if "non-banded" in case:
        crosses = [m for m in minors if m[2] // WARP != (m[2] + m[3] - 1)
                   // WARP]
        assert crosses and seg.nrun_minor > len(minors)


def test_segments_ragged_and_reordered_bands():
    """Bands of 5, 27, 3, 40, 1 and 20 g-points (96), their flavors, and
    minor windows that cross 32 and 64 or lie inside one warp; then the
    same g-points with the bands in another order (gpt2band not
    monotone)."""
    sizes = (5, 27, 3, 40, 1, 20)
    g2b = np.repeat(np.arange(len(sizes)), sizes)
    flav_of_band = np.array([[0, 1, 2, 0, 3, 1], [4, 4, 1, 2, 0, 3]])
    gfl = flav_of_band[:, g2b]
    minors = ((1, 0, 24, 16, 1), (1, 2, 60, 10, 17), (0, 3, 0, 96, 1),
              (0, 4, 33, 2, 97), (1, 2, 28, 8, 27))
    seg = _check(g2b, gfl, minors, 5)
    assert seg.nslot == 4
    perm = np.array([3, 0, 5, 1, 4, 2])
    _check(perm[g2b], flav_of_band[:, perm[g2b]], minors, 5, seed=1)


def test_segments_idle_lanes_and_many_minors():
    """40 g-points (24 idle lanes in the second warp) and 28 minors on the
    same 8 g-points (the small test configurations): more minor slots
    than the kernels keep in registers."""
    g2b = np.repeat(np.arange(5), 8)
    gfl = np.stack([g2b % 3, (g2b + 1) % 3])
    minors = tuple((int(m < 16), m % 3, 0, 8, 1 + 8 * m) for m in range(28))
    seg = _check(g2b, gfl, minors, 3)
    assert seg.nslot == 28


def test_segments_on_caches_per_kdist():
    """One table per k-distribution's tensors, rebuilt for another
    gpt2band."""
    g2b, gfl, minors, nflav = _kdist_case(False)
    b, f = torch.as_tensor(g2b), torch.as_tensor(gfl)
    s1, t1 = segments_on(b, f, minors, nflav)
    s2, t2 = segments_on(b, f, minors, nflav)
    assert t1 is t2 and t1.dtype == torch.int32
    assert np.array_equal(t1.numpy(), s1.table)
    _, t3 = segments_on(b.clone(), f, minors, nflav)
    assert t3 is not t1 and torch.equal(t3, t1)


def test_adjoint_scratch_bytes():
    """The adjoints' device scratch at 4096 x 72, as PERF.md states it:
    fused_sw_bwd 2,128,609,280 B (at most half of the 4.28 GB it took
    before), fused_lw_bwd 1,207,959,552 B, solver_sw_bwd none (its state
    is held in shared memory; 1,335,885,824 B while it was kept in device
    memory)."""
    assert sw_fused_bwd_scratch_bytes(4096, 72, 224) == 2_128_609_280
    assert sw_fused_bwd_scratch_bytes(4096, 72, 224) <= 4_275_634_176 // 2
    assert lw_fused_bwd_scratch_bytes(4096, 72, 256) == 1_207_959_552
    assert sw_2stream_bwd_scratch_bytes(4096, 72, 224) == 0


def test_col_gas_h2o_absent_yields_zero_column():
    """A k-distribution without 'h2o' (tests/test_r5_regressions.py:284):
    the port's col_gas points idx_h2o at an all-zero row, the real gases
    untouched, and every row equals the JAX package's."""
    class KD:
        gas_names = ("co2", "n2")

        def idx_gas(self, name):
            key = name.lower()
            return (self.gas_names.index(key) + 1
                    if key in self.gas_names else -1)

    stub = SimpleNamespace(kdist=KD())
    ncol, nlay = 3, 4
    play = np.full((ncol, nlay), 500e2, np.float32)
    plev = np.broadcast_to(np.linspace(1000e2, 100e2, nlay + 1,
                                       dtype=np.float32)[None],
                           (ncol, nlay + 1)).copy()
    tlay = np.full((ncol, nlay), 270.0, np.float32)
    gc = GasConcs.empty().set_vmr("co2", 400e-6).set_vmr("n2", 0.78)
    col_gas, col_dry, idx_h2o = GasOpticsRRTMGP.col_gas(
        stub, torch.as_tensor(play), torch.as_tensor(plev), gc)
    assert idx_h2o >= 0
    assert torch.all(col_gas[idx_h2o] == 0.0)
    assert torch.all(col_gas[KD().idx_gas("n2")] > 0.0)
    jgc = JaxGasConcs.empty().set_vmr("co2", 400e-6).set_vmr("n2", 0.78)
    jcol, jdry, jidx = JaxGasOptics._col_gas(
        stub, jnp.asarray(play), jnp.asarray(plev), jnp.asarray(tlay), jgc,
        None)
    assert jidx == idx_h2o
    np.testing.assert_allclose(col_gas.numpy(), np.asarray(jcol), rtol=1e-6)
    np.testing.assert_allclose(col_dry.numpy(), np.asarray(jdry), rtol=1e-6)
