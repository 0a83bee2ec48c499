"""The whole-grid stream (``parallel/scaling.AllSkyStream``) on the CPU at
toy widths (16 g-points in 2 bands a side, 4 temperatures, 6 pressures),
on a grid of 3 chunks of 8 columns and a ragged one of 5, 6 layers:

  * LW bit for bit the fused all-sky step (``allsky_step_lw``) on the whole
    grid; SW on the day columns (``mu0 > 0``) bit for bit ``allsky_step_sw``
    on those columns alone, and exactly 0 on the night ones; with half the
    columns night at random, and with chunks all day (no gather), all
    night (no SW) and mixed; without aerosols and with MERRA aerosols
    (the stream given ``aerosol_lw`` and ``aerosol_sw``, the step run with
    ``use_aerosols``);
  * the sweep's counters exact: 4 chunks, the day columns, the bytes of
    the fields the step reads (the aerosol fields too where it has
    aerosol optics), of the scalar and profile gases once and of the
    gathered chunks' int32 day indices up, five flux profiles down; its
    spans;
  * without aerosol optics the sweep reads no aerosol field; with them
    the fluxes move; the stream takes both aerosol optics or neither;
  * a chunk read from another grid of the pool changes that chunk's
    outputs and no other's; the host buffers are the next sweep's;
  * a grid that is not in host memory is refused.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch import trace  # noqa: E402
from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_step_lw, allsky_step_sw, build_allsky)
from rte_rrtmgp_tpu_torch.gas_concs import GasConcs  # noqa: E402
from rte_rrtmgp_tpu_torch.parallel import scaling  # noqa: E402
from rte_rrtmgp_tpu_torch.parallel.scaling import (  # noqa: E402
    AEROSOL_FIELDS, STEP_FIELDS, AllSkyStream, _pool_entry)

CHUNK, NLAY = 8, 6
NCOL = 3 * CHUNK + 5
TOY = (16, 2, 16, 2, 4, 6)
FIELDS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")


def _mu0(pattern):
    """``half``: half the columns night, in random places; ``blocks``:
    chunk 0 all day, chunk 1 all night, chunks 2 and 3 mixed."""
    if pattern == "half":
        g = torch.Generator().manual_seed(3)
        return torch.linspace(-0.95, 0.9, NCOL)[torch.randperm(NCOL,
                                                               generator=g)]
    mu0 = torch.full((NCOL,), 0.6)
    mu0[CHUNK:2 * CHUNK] = -0.3
    mu0[2 * CHUNK + 1::2] = -0.5
    mu0[2 * CHUNK + 2] = 0.0                       # the terminator: night
    return mu0


@pytest.fixture(scope="module")
def problem():
    return build_allsky(NCOL, NLAY, *TOY, device="cpu", use_aerosols=True)


def _grid(p, pattern, j=0):
    return _pool_entry(p.inputs, j)._replace(mu0=_mu0(pattern))


def _stream(p, aerosols=False):
    aer = dict(aerosol_lw=p.aer_lw, aerosol_sw=p.aer_sw) if aerosols else {}
    return AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw, chunk=CHUNK,
                        device="cpu", **aer)


def _rows(grid, idx):
    """The step's fields of the columns ``idx``, aerosols included."""
    gas = grid.gas_concs
    return grid._replace(
        gas_concs=GasConcs(names=gas.names, values=tuple(
            v[idx] if v.ndim == 2 else v for v in gas.values)),
        **{f: getattr(grid, f)[idx] for f in STEP_FIELDS + AEROSOL_FIELDS})


def _optics(p, band, aerosols):
    """The step's optics keywords for ``band`` (lw or sw)."""
    kw = dict(cloud_optics=getattr(p, f"cld_{band}"))
    if aerosols:
        kw.update(aerosol_optics=getattr(p, f"aer_{band}"), use_aerosols=True)
    return kw


@pytest.mark.parametrize("aerosols", [False, True], ids=["noaer", "aer"])
@pytest.mark.parametrize("pattern", ["half", "blocks"])
def test_stream_matches_fused_step(problem, pattern, aerosols):
    p = problem
    grid = _grid(p, pattern)
    out = _stream(p, aerosols).run(grid)
    assert all(tuple(f.shape) == (NCOL, NLAY + 1) for f in out)
    lw = allsky_step_lw(grid, p.gas_lw, **_optics(p, "lw", aerosols))
    assert torch.equal(out.lw_up, lw.flux_up)
    assert torch.equal(out.lw_dn, lw.flux_dn)
    day = torch.nonzero(grid.mu0 > 0).flatten()
    night = grid.mu0 <= 0
    assert 0 < day.numel() < NCOL
    sw = allsky_step_sw(_rows(grid, day), p.gas_sw,
                        **_optics(p, "sw", aerosols))
    for got, ref in zip(out[2:], (sw.flux_up, sw.flux_dn, sw.flux_dn_dir)):
        assert torch.equal(got[day], ref)
        assert bool((got[night] == 0).all())
        assert bool((ref[:, 0] > 0).all())


def _bytes_up(grid, aerosols):
    """What a sweep copies up: the step's fields (with the aerosol fields
    where it has aerosols) and the gas fields of every column, the scalar
    and profile gases once, and the day indices of each chunk that is
    neither all day nor all night."""
    size = lambda t: t.numel() * t.element_size()
    fields = STEP_FIELDS + (AEROSOL_FIELDS if aerosols else ())
    n = sum(size(getattr(grid, f)) for f in fields)
    n += sum(size(v) for v in grid.gas_concs.values)
    for c0 in range(0, NCOL, CHUNK):
        lit = int((grid.mu0[c0:c0 + CHUNK] > 0).sum())
        if 0 < lit < min(CHUNK, NCOL - c0):
            n += 4 * lit
    return n


@pytest.mark.parametrize("aerosols", [False, True], ids=["noaer", "aer"])
@pytest.mark.parametrize("pattern", ["half", "blocks"])
def test_stream_counts_and_spans(problem, pattern, aerosols):
    grid = _grid(problem, pattern)
    stream = _stream(problem, aerosols)
    with trace.collect() as rec:
        out = stream.run(grid)
    c = rec.counters
    assert c["stream.chunks"] == 4
    assert c["stream.sw_columns"] == int((grid.mu0 > 0).sum())
    assert c["stream.bytes_up"] == _bytes_up(grid, aerosols)
    assert c["stream.bytes_down"] == 5 * NCOL * (NLAY + 1) * 4 == sum(
        f.numel() * f.element_size() for f in out)
    names = [r[0] for r in rec.spans]
    mixed = sum(0 < int((grid.mu0[c0:c0 + CHUNK] > 0).sum())
                < min(CHUNK, NCOL - c0) for c0 in range(0, NCOL, CHUNK))
    assert names.count("stream.sweep") == 1
    assert [names.count(n) for n in ("stream.upload", "stream.chunk",
                                     "stream.readback")] == [4, 4, 4]
    assert names.count("stream.day_gather") == 2 * mixed
    sweep = next(r for r in rec.spans if r[0] == "stream.sweep")
    assert sweep[2] is None and all(
        r[1] == sweep[1] for r in rec.spans if r[0].startswith("stream."))
    if pattern == "blocks":
        assert mixed == 2
    # one aerosol lookup per gas-optics call: 4 LW and the SW chunks'
    sw_chunks = sum(int((grid.mu0[c0:c0 + CHUNK] > 0).sum()) > 0
                    for c0 in range(0, NCOL, CHUNK))
    assert names.count("aerosol.optics") == (4 + sw_chunks if aerosols
                                             else 0)


def test_stream_without_aerosol_optics_reads_no_aerosol_field(problem):
    p = problem
    grid = _grid(p, "half")
    want = [f.clone() for f in _stream(p).run(grid)]
    bare = grid._replace(**{f: None for f in AEROSOL_FIELDS})
    got = _stream(p).run(bare)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    aer = _stream(p, aerosols=True).run(grid)
    assert not torch.equal(aer.lw_up, want[0])
    assert not torch.equal(aer.sw_up, want[2])


def test_stream_takes_both_aerosol_optics_or_neither(problem):
    p = problem
    for one in (dict(aerosol_lw=p.aer_lw), dict(aerosol_sw=p.aer_sw)):
        with pytest.raises(ValueError, match="both"):
            AllSkyStream(p.gas_lw, p.gas_sw, p.cld_lw, p.cld_sw,
                         chunk=CHUNK, device="cpu", **one)


def test_chunk_from_another_grid_changes_its_outputs(problem, monkeypatch):
    """Grids 0 and 1 of a pool (grid 1 warmer and wetter); a fault that
    uploads chunk 2 from grid 0 while sweeping grid 1 changes chunk 2's
    rows, and only those."""
    p = problem
    stream = _stream(p)
    ref = [f.clone() for f in stream.run(_grid(p, "half", 1))]
    other = _grid(p, "half", 0)
    put = scaling._Uploads.put

    def wrong(self, k, src, day=None):
        if k == 2:
            src = scaling._columns(other, 2 * CHUNK, 3 * CHUNK)
        put(self, k, src, day)

    monkeypatch.setattr(scaling._Uploads, "put", wrong)
    got = stream.run(_grid(p, "half", 1))
    rows = slice(2 * CHUNK, 3 * CHUNK)
    for name, a, b in zip(FIELDS, got, ref):
        assert torch.equal(torch.cat([a[:rows.start], a[rows.stop:]]),
                           torch.cat([b[:rows.start], b[rows.stop:]])), name
    for a, b in zip(got[:2], ref[:2]):
        assert not torch.equal(a[rows], b[rows])


def test_outputs_are_the_next_sweeps(problem):
    p = problem
    stream = _stream(p)
    first = stream.run(_grid(p, "half", 0))
    lw0 = first.lw_up.clone()
    second = stream.run(_grid(p, "half", 1))
    assert all(a is b for a, b in zip(first, second))
    assert not torch.equal(second.lw_up, lw0)
    lw = allsky_step_lw(_grid(p, "half", 1), p.gas_lw, cloud_optics=p.cld_lw)
    assert torch.equal(second.lw_up, lw.flux_up)


def test_grid_must_be_in_host_memory(problem):
    grid = _grid(problem, "half")
    with pytest.raises(ValueError, match="host memory"):
        _stream(problem).run(grid._replace(play=grid.play.to("meta")))
    with pytest.raises(ValueError, match="chunk"):
        AllSkyStream(problem.gas_lw, problem.gas_sw, problem.cld_lw,
                     problem.cld_sw, chunk=0, device="cpu")
