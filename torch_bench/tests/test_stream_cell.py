"""The whole-grid cell, ``ne30pg2.stream.fwd``, on the CPU at the
configuration's spectral widths, cut to 3 chunks of 8 columns and a
ragged one of 5 (the program runs its plain twins here):

    python -m pytest -q torch_bench/tests/test_stream_cell.py

  * the program passes the cell's limits against the plain reference
    (``reference/allsky.py``), and the control (the reference in bfloat16
    put in the program's place) fails them;
  * a whole run with the stream broken underneath reads ``correct`` false:
    the ragged last chunk dropped, one night column solved, or one
    column's answer altered; sound, true;
  * the stream's counters equal ``work/stream_copy.py``'s bytes and the
    chunks the grid makes.
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

CELL = "ne30pg2.stream.fwd"
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
        assert any(nums[n] > limits[n] for n in limits), nums


def _plant(fault, monkeypatch):
    from rte_rrtmgp_tpu_torch.parallel.scaling import AllSkyStream
    if fault == "tail":
        bounds = AllSkyStream._bounds
        monkeypatch.setattr(AllSkyStream, "_bounds", lambda self, n: [
            b for b in bounds(self, n) if b[1] - b[0] == self.chunk])
    elif fault == "night":
        def lit(mu0):
            night = torch.nonzero(mu0 <= 0).flatten()[:1]
            return torch.sort(torch.cat([torch.nonzero(mu0 > 0).flatten(),
                                         night])).values
        monkeypatch.setattr(AllSkyStream, "_day_columns", staticmethod(lit))
    elif fault == "altered":
        entry = harness.load("entries", "allsky_stream").Entry
        forward = entry.forward

        def altered(self, x, span):
            out = [f.clone() for f in forward(self, x, span)]
            out[0][3] *= 1.5
            return tuple(out)
        monkeypatch.setattr(entry, "forward", altered)


@pytest.mark.parametrize("fault", ["sound", "tail", "night", "altered"])
def test_run_catches_faults(fault, monkeypatch):
    _plant(fault, monkeypatch)
    r = harness.run_cell(CELL, 2 ** 31 + 12345, 0.3, False,
                         torch.device("cpu"), time.perf_counter(),
                         small_spec())
    assert r["correct"] == (fault == "sound"), r["check"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {
        "setup_s", "columns_per_s", "step_p95_ms"}
    if fault == "night":
        assert r["check"]["sw_night"]["value"] > 0


def test_counters_agree_with_work():
    from rte_rrtmgp_tpu_torch import trace
    spec = small_spec()
    config, cell = spec["config"], spec["cell"]
    data = generator.make(config, cell["traffic"], 2 ** 31 + 99, "cpu")
    entry = harness.load("entries", "allsky_stream").Entry(data, config,
                                                           "cpu")
    work = harness.load("work", "stream_copy")
    shapes = generator.shapes(config)
    for x in entry.inputs:
        with trace.collect() as rec:
            entry.forward(x, harness.Spans())
        c = rec.counters
        assert (c["stream.bytes_up"], c["stream.bytes_down"]) == \
            work.copy_bytes(shapes, work.day_indices(x.mu0, CHUNK))
        assert c["stream.chunks"] == 4
        assert c["stream.sw_columns"] == int((x.mu0 > 0).sum())
