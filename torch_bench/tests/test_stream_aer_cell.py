"""The whole-grid cell with MERRA aerosols, ``ne30pg2_aer.stream.fwd``, on
the CPU at the configuration's spectral widths, cut to 3 chunks of 8
columns and a ragged one of 5 (the program runs its plain twins here):

    python -m pytest -q torch_bench/tests/test_stream_aer_cell.py

  * the program passes the cell's limits against the plain reference
    (``reference/allsky_aer.py``), and the control (the reference in
    bfloat16 put in the program's place) fails them, each of the
    aerosol numbers of ``steps/grid_aer.py`` among them;
  * a whole run with the stream broken underneath reads ``correct``
    false: the ragged last chunk dropped, one column's answer altered,
    the step run without its aerosols, the aerosol mass left out of the
    inputs, or the lookup reading another species' rows, RH pair or
    size bin; sound, true;
  * the stream's counters: the bytes up are ``work/stream_copy.py``'s
    and the four aerosol fields of every column; one aerosol lookup per
    gas-optics call;
  * ``work/aerosol_props.py`` counts the sweep's launches from the
    chunks and the day share.
"""
import copy
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from torch_bench import harness  # noqa: E402
from torch_bench.traffic import generator  # noqa: E402

CELL = "ne30pg2_aer.stream.fwd"
CHUNK, NCOL, NLAY = 8, 3 * 8 + 5, 20


def small_spec():
    spec = copy.deepcopy(harness.cell_spec(CELL))
    spec["config"].update(ncol=NCOL, nlay=NLAY, chunk=CHUNK)
    return spec


def test_program_passes_and_control_fails():
    from torch_bench import control
    spec = small_spec()
    limits = spec["cell"]["check"]["limits"]
    seen = {}
    for r in control.readings(spec, [7, 8], [7, 8], torch.device("cpu")):
        seen.setdefault(r["who"], []).append(r["numbers"])
    for nums in seen["program"]:
        assert all(nums[n] <= limits[n] for n in limits), nums
    for nums in seen["control bfloat16"]:
        assert all(nums[n] > limits[n] for n in
                   ("lw_up", "lw_dn", "lw_aer", "sw_aer", "aer_optics")), nums


def _plant(fault, monkeypatch):
    from rte_rrtmgp_tpu_torch.parallel.scaling import AllSkyStream
    if fault == "tail":
        bounds = AllSkyStream._bounds
        monkeypatch.setattr(AllSkyStream, "_bounds", lambda self, n: [
            b for b in bounds(self, n) if b[1] - b[0] == self.chunk])
    elif fault == "no_aerosols":
        init = AllSkyStream.__init__

        def without(self, *args, **kw):
            init(self, *args, **kw)
            self.aerosols = False             # fields up, not used
        monkeypatch.setattr(AllSkyStream, "__init__", without)
    elif fault == "massless":
        mod = harness.load("entries", "allsky_stream_aer")
        inputs = mod.inputs
        monkeypatch.setattr(mod, "inputs", lambda state: inputs(state)._replace(
            aero_mass=torch.zeros_like(state["aero_mass"])))
    elif fault in ("species", "rh_pair", "size_bin"):
        from rte_rrtmgp_tpu_torch.models.rrtmgp.aerosol_optics import \
            AerosolOpticsMERRA
        post = AerosolOpticsMERRA.__post_init__

        def misread(self):
            post(self)
            lims, rh, table = self.lut
            if fault == "species":            # dust's rows for sulfate's
                o = list(self.offsets)
                o[0], o[2] = o[2], o[0]
                object.__setattr__(self, "offsets", tuple(o))
            elif fault == "rh_pair":          # the RH grid one step off
                object.__setattr__(self, "lut", (lims, rh + rh[1], table))
            else:                             # each bin the next one's
                object.__setattr__(self, "lut", (lims.roll(1, 1), rh, table))
        monkeypatch.setattr(AerosolOpticsMERRA, "__post_init__", misread)
    elif fault == "altered":
        entry = harness.load("entries", "allsky_stream_aer").Entry
        forward = entry.forward

        def altered(self, x, span):
            out = [f.clone() for f in forward(self, x, span)]
            out[0][3] *= 1.5
            return tuple(out)
        monkeypatch.setattr(entry, "forward", altered)


@pytest.mark.parametrize("fault", ["sound", "tail", "altered", "no_aerosols",
                                   "massless", "species", "rh_pair",
                                   "size_bin"])
def test_run_catches_faults(fault, monkeypatch):
    _plant(fault, monkeypatch)
    r = harness.run_cell(CELL, 2 ** 31 + 12345, 0.3, False,
                         torch.device("cpu"), time.perf_counter(),
                         small_spec())
    assert r["correct"] == (fault == "sound"), r["check"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {
        "setup_s", "columns_per_s", "step_p95_ms"}


def test_counters_agree_with_work():
    from rte_rrtmgp_tpu_torch import trace
    spec = small_spec()
    config, cell = spec["config"], spec["cell"]
    data = generator.make(config, cell["traffic"], 2 ** 31 + 99, "cpu")
    entry = harness.load("entries", "allsky_stream_aer").Entry(data, config,
                                                               "cpu")
    work = harness.load("work", "stream_copy")
    shapes = generator.shapes(config)
    aerosols = 4 * 4 * NCOL * NLAY
    for x in entry.inputs:
        with trace.collect() as rec:
            entry.forward(x, harness.Spans())
        c = rec.counters
        up, down = work.copy_bytes(shapes, work.day_indices(x.mu0, CHUNK))
        assert (c["stream.bytes_up"], c["stream.bytes_down"]) == \
            (up + aerosols, down)
        sw_chunks = sum(bool((x.mu0[c0:c0 + CHUNK] > 0).any())
                        for c0 in range(0, NCOL, CHUNK))
        names = [r[0] for r in rec.spans]
        assert names.count("aerosol.optics") == 4 + sw_chunks
        assert names.count("kernel.aerosol_props") == 4 + sw_chunks


def test_aerosol_work_counts_the_sweeps_launches():
    spec = small_spec()
    shapes = generator.shapes(spec["config"])
    w = harness.load("work", "aerosol_props")
    b, ops = w.work(shapes, spec["cell"])
    lw = w.launch_work(shapes, NCOL, shapes["nbnd_lw"], False)
    sw = w.launch_work(shapes, round(0.5 * NCOL), shapes["nbnd_sw"], True)
    once = [w.launch_work(shapes, 0, shapes[f"nbnd_{s}"], s == "sw")[0]
            for s in ("lw", "sw")]
    assert (b, ops) == (lw[0] + sw[0] + 3 * sum(once), lw[1] + sw[1])
    ncell = NCOL * NLAY
    assert lw[0] - once[0] == ncell * (16 + 16 * 4 * 3)
    assert sw[0] - once[1] == round(0.5 * NCOL) * NLAY * (16 + 14 * 4 * 6)
