"""The benchmark generator's pinned data in the tier-1 run:

  * the cases of ``torch_bench/tests/test_generator.py``, collected here
    from that file unchanged: each of its cells draws at its full size
    the sha256 digests pinned there, its ``shapes`` are those pinned
    there, and a problem's own file brings its tables, states and sizes
    without moving the shared tables;
  * the aerosol cell, ``ne30pg2_aer.stream.fwd`` (problem
    ``allsky_aer``), at its full size: its shared tables are the other
    cells' (the same digests), and its MERRA tables and pool draw the
    digests pinned here, recorded when the cell was added (the CPU
    generator, torch 2.13), with the same ``digests``; its ``shapes``
    add the tables' sizes and the stream's chunk.
"""
import importlib.util
import os

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torch_bench", "tests", "test_generator.py")
_spec = importlib.util.spec_from_file_location("torch_bench_test_generator",
                                               _PATH)
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

globals().update({k: v for k, v in vars(_gen).items()
                  if k.startswith("test_") or k == "problem_file"})

AEROSOL_CELL = dict(
    _gen.TABLES,
    aerosol_lw="9df7a3e6078a8343b3579e449c987e49"
               "b046cf4f29f379f48f357261a61e8c76",
    aerosol_sw="b22ab79cec72c06ad42157d7b95f71e0"
               "5cfc6d7584bcc10283440b31a60d63c0",
    pool="936a825d509389494f2e547b393e77c5723802a3498a42119c8604994050e264")


def test_aerosol_cell_draws_its_pinned_data():
    spec = _gen.harness.cell_spec("ne30pg2_aer.stream.fwd")
    data = _gen.generator.make(spec["config"], spec["cell"]["traffic"],
                               _gen.SEED, "cpu")
    got = _gen.digests(data)
    assert list(got) == list(AEROSOL_CELL)
    assert got == AEROSOL_CELL


def test_aerosol_cell_shapes():
    cfg = _gen.harness.read_json("configs", "ne30pg2_aer.json")
    assert _gen.generator.shapes(cfg) == dict(
        _gen.SHAPES["ne30pg2"], aerosol_nbin=5, aerosol_nrh=37, chunk=4096)
