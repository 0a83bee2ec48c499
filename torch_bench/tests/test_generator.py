"""The generator's data, pinned, on the CPU:

    python -m pytest -q torch_bench/tests/test_generator.py

  * every cell draws, at its configuration's full size with its own
    traffic, bit for bit what the generator drew at commit 5c530e2 (before
    each problem's inputs moved into ``traffic/<problem>.py``): the same
    keys in the same order, and the sha256 of every tensor and array
    under each key; its ``shapes`` are that commit's;
  * a problem found by name: a throwaway ``traffic/<problem>.py`` brings
    its own tables, pool states and sizes, drawn after the shared tables,
    which it leaves as they were;
  * a problem with no file fails with an error that names the file.

The digests are of the CPU generator's draws (``torch.Generator`` on the
CPU, torch 2.13). A torch whose CPU generator draws otherwise needs them
written again from commit 5c530e2 with :func:`digests`.
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from torch_bench import harness  # noqa: E402
from torch_bench.traffic import generator  # noqa: E402

SEED = 2 ** 31 + 2022
# the shared tables at SEED, whatever the configuration's columns
TABLES = dict(
    lw="653512347ff948ef0d3264e0d5dc74d16770bafbf516465464cbcbd985904862",
    sw="c87906646f4aa3951ff44c4ece5298cb0bd06e5ba969d17f1e5c0b23c40d2069",
    cloud_lw="e56b923f53e3bcf8a395159c1350d1bde2afef976ab4e8c92684a32ce6fa19b9",
    cloud_sw="5b50b9930e38e22014261500d82145f5d072e3e25f86c7e77c4508f9ece235a1")
ALLSKY = dict(TABLES, pool="ba5abef3087b61e49ab86bd3516df41630135e677bf362aa"
                           "8099c77127281eca")
# each cell's keys in make()'s order and their digests at commit 5c530e2
PARENT = {
    "allsky.fused.fwd": ALLSKY,
    "allsky.fused.grad": ALLSKY,
    "allsky.api.fwd": ALLSKY,
    "rfmip.fused.fwd": dict(
        lw=TABLES["lw"], sw=TABLES["sw"],
        pool="83af0a6f767e14a5b2f14658dd94ef2d74ac56fc22099ada2b446cab254800d3"),
    "ne30pg2.stream.fwd": dict(
        TABLES,
        pool="1db9181792b1a40a6d112252495050c6dfec73cb9af44a4a6cf59ae5283cc822"),
}


def _spectral():
    return dict(ntemp=14, neta=9, npres=59, nplanck=196, ngpt_lw=256,
                nbnd_lw=16, nflav_lw=7, minor_widths_lw_lower=[16] * 38,
                minor_widths_lw_upper=[16] * 36, ngpt_sw=224, nbnd_sw=14,
                nflav_sw=7, minor_widths_sw_lower=[16] * 34,
                minor_widths_sw_upper=[16] * 26)


# generator.shapes of each configuration at commit 5c530e2
SHAPES = {
    "allsky": dict(ncol=4096, nlay=72, clouds=True, **_spectral()),
    "rfmip": dict(ncol=1800, nlay=60, clouds=False, **_spectral()),
    "ne30pg2": dict(ncol=21600, nlay=72, clouds=True, **_spectral()),
}


def _feed(h, x):
    if isinstance(x, torch.Tensor):
        h.update(f"tensor {x.dtype} {tuple(x.shape)};".encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    elif isinstance(x, (np.ndarray, np.generic)):
        x = np.asarray(x)
        h.update(f"array {x.dtype} {x.shape};".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, dict):
        h.update(f"dict {len(x)};".encode())
        for k, v in x.items():
            h.update(f"key {k!r};".encode())
            _feed(h, v)
    elif isinstance(x, (list, tuple)):
        h.update(f"{type(x).__name__} {len(x)};".encode())
        for v in x:
            _feed(h, v)
    else:
        h.update(f"{type(x).__name__} {x!r};".encode())


def digests(data: dict) -> dict:
    """The sha256 of each of ``make()``'s keys, in its order: every
    tensor's and array's dtype, shape and bytes, every other value's repr
    and every key, in order."""
    out = {}
    for k, v in data.items():
        h = hashlib.sha256()
        _feed(h, v)
        out[k] = h.hexdigest()
    return out


@pytest.mark.parametrize("workload", sorted(PARENT))
def test_cell_draws_the_parents_data(workload):
    spec = harness.cell_spec(workload)
    data = generator.make(spec["config"], spec["cell"]["traffic"], SEED,
                          "cpu")
    got = digests(data)
    assert list(got) == list(PARENT[workload])
    assert got == PARENT[workload]


@pytest.mark.parametrize("config", sorted(SHAPES))
def test_shapes_are_the_parents(config):
    cfg = harness.read_json("configs", config + ".json")
    assert generator.shapes(cfg) == SHAPES[config]


def _small(problem):
    """The allsky configuration at 24 x 20 under another problem name,
    and its fused cell's traffic (read from the repository's benchmark
    directory, whatever ``harness.BENCH`` points at)."""
    bench = os.path.join(ROOT, "torch_bench")
    with open(os.path.join(bench, "configs", "allsky.json")) as f:
        config = json.load(f)
    with open(os.path.join(bench, "workloads", "allsky.fused.fwd.json")) as f:
        traffic = json.load(f)["traffic"]
    return dict(config, ncol=24, nlay=20, problem=problem), traffic


TOY = '''
def tables(config, data, draw):
    return dict(toy_table=draw.uniform(
        (3, len(data["sw"]["band_lims_wvn"])), 0.0, 1.0))


def state(config, traffic, draw):
    return dict(toy_field=draw.uniform((config["ncol"], config["nlay"]),
                                       0.0, 1.0))


def shapes(config):
    return dict(toy_nbin=3)
'''


@pytest.fixture
def problem_file(tmp_path, monkeypatch):
    """Writes ``traffic/<name>.py`` under a benchmark directory in
    ``tmp_path`` that the generator searches; the loaded module is
    dropped afterwards."""
    monkeypatch.setattr(harness, "BENCH", str(tmp_path))
    (tmp_path / "traffic").mkdir()

    def write(name, source):
        (tmp_path / "traffic" / (name + ".py")).write_text(source)
        mod_name = "torch_bench_traffic_" + name
        monkeypatch.setitem(sys.modules, mod_name, None)
        del sys.modules[mod_name]
    return write


def test_a_problem_brings_its_own_tables_states_and_sizes(problem_file):
    problem_file("toy", TOY)
    config, traffic = _small("toy")
    data = generator.make(config, traffic, SEED, "cpu")
    assert list(data) == ["lw", "sw", "cloud_lw", "cloud_sw", "toy_table",
                          "pool"]
    got = digests(data)
    assert {k: got[k] for k in TABLES} == TABLES
    # drawn after the shared tables and before the pool
    draw = generator.Draw(SEED, "cpu")
    lw = generator.kdist_raw(config, False, draw)
    sw = generator.kdist_raw(config, True, draw)
    generator.cloud_raw(config, lw["band_lims_wvn"], draw)
    generator.cloud_raw(config, sw["band_lims_wvn"], draw)
    assert torch.equal(data["toy_table"], draw.uniform((3, 14), 0.0, 1.0))
    assert len(data["pool"]) == traffic["pool"]
    for st in data["pool"]:
        assert set(st) == {"toy_field"}
        assert st["toy_field"].shape == (24, 20)
    assert generator.shapes(config) == dict(SHAPES["allsky"], ncol=24,
                                            nlay=20, toy_nbin=3)


@pytest.mark.parametrize("call", ["make", "shapes"])
def test_a_problem_without_a_file_names_the_file(call):
    config, traffic = _small("no_such_problem")
    with pytest.raises(FileNotFoundError,
                       match="torch_bench/traffic/no_such_problem.py"):
        if call == "make":
            generator.make(config, traffic, SEED, "cpu")
        else:
            generator.shapes(config)
