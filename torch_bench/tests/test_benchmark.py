"""The benchmark's own tests, on the CPU at small sizes (the program runs
its plain twins there):

    python -m pytest -q torch_bench/tests

  * the plain reference equals the program's float64 twins (fluxes and
    the gradient step's gradients): it computes what the program does;
  * the control (the reference in bfloat16 put in the program's place)
    fails each cell's limits, and the program's float32 twins pass them;
  * the water vapour's 90th percentile fails a gradient fault on a fifth
    of the columns that its median cannot see;
  * a whole run of each cell, its card look skipped, with the timed path
    broken underneath (half the columns left out; one column's answer
    altered where it is produced) comes out not correct, and sound comes
    out correct;
  * a run in a process that holds JAX, jaxlib, flax or the JAX package
    once its check is done gives no result.
"""
import copy
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from torch_bench import harness  # noqa: E402
from torch_bench.traffic import generator  # noqa: E402

CELLS = ("allsky.fused.fwd", "rfmip.fused.fwd", "allsky.fused.grad",
         "allsky.api.fwd")


def small_spec(workload, nlay=20):
    """The cell at 24 columns (8 sites x 3 experiments) and ``nlay``
    layers; the spectral widths and tables stay the configuration's, so
    the float32 gaps read as at the timed size."""
    spec = copy.deepcopy(harness.cell_spec(workload))
    c = spec["config"]
    if "ncol" in c:
        c["ncol"] = 24
    else:
        c["nsite"], c["nexp"] = 8, 3
    c["nlay"] = nlay
    return spec


def program64(spec, data, state):
    """The program's outputs of one state in float64 (its twins)."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import AllSkyInputs
    from torch_bench.entries import common
    f64 = torch.float64
    from rte_rrtmgp_tpu_torch.models.rrtmgp.cloud_optics import \
        CloudOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist
    cell, config = spec["cell"], spec["config"]
    host = generator.host
    gas = lambda raw: GasOpticsRRTMGP(KDist.from_raw(
        generator.GASES, dtype=f64, device="cpu", **host(raw)))
    p = common.Optics(gas(data["lw"]), gas(data["sw"]), *(
        CloudOpticsRRTMGP.load(dtype=f64, device="cpu", **host(data[k]))
        if k in data else None for k in ("cloud_lw", "cloud_sw")))
    entry_mod = harness.load("entries", cell["entry"])
    entry = entry_mod.Entry.__new__(entry_mod.Entry)
    entry.p = p
    if config["problem"] == "allsky":
        x = common.allsky_inputs(state)
        x = AllSkyInputs(*[v.double() if isinstance(v, torch.Tensor)
                           and v.is_floating_point() else v for v in x])
        x = x._replace(gas_concs=x.gas_concs.to(dtype=f64))
    else:
        import dataclasses
        x = common.rfmip_data(state, config)
        x = dataclasses.replace(
            x, gas_concs=x.gas_concs.to(dtype=f64), **{
                k: getattr(x, k).astype(np.float64)
                for k in ("play", "plev", "tlay", "tlev", "sfc_t",
                          "sfc_emis", "sfc_alb", "tsi", "sza")})
    entry.inputs = [x]
    step = harness.load("steps", cell["step"]).Step(entry, cell,
                                                    entry_mod.OUTPUTS)
    return step, step.run(0, harness.Spans())


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_program_float64(workload):
    spec = small_spec(workload, nlay=72 if "grad" in workload else 20)
    data = generator.make(spec["config"], spec["cell"]["traffic"], 5, "cpu")
    state = data["pool"][1]
    step, out = program64(spec, data, state)
    refmod = harness.load("reference", spec["config"]["problem"])
    ref = step.reference(refmod, data, state)
    got = step.numbers(out, ref, state)
    limit = 1e-10 if "fwd" in workload else 1e-6
    assert all(v < limit for v in got.values()), got


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    from torch_bench import control
    spec = small_spec(workload, nlay=72 if "grad" in workload else 20)
    limits = spec["cell"]["check"]["limits"]
    seen = {}
    for r in control.readings(spec, [7, 8], [7, 8], torch.device("cpu")):
        seen.setdefault(r["who"], []).append(r["numbers"])
    for nums in seen["program"]:
        assert all(nums[n] <= limits[n] for n in limits), nums
    for nums in seen["control bfloat16"]:
        assert any(nums[n] > limits[n] for n in limits), nums


def test_h2o_p90_catches_a_fault_on_a_fifth_of_the_columns():
    """The water vapour's gradient four times too large in a fifth of the
    columns: the median over cells cannot see it, the 90th percentile
    fails it."""
    spec = small_spec("allsky.fused.grad", nlay=72)
    limits = spec["cell"]["check"]["limits"]
    data = generator.make(spec["config"], spec["cell"]["traffic"], 5, "cpu")
    state = data["pool"][1]
    step, out = program64(spec, data, state)
    ref = step.reference(harness.load("reference", "allsky"), data, state)
    h2o = out["h2o"].clone()
    h2o[:h2o.shape[0] // 5] *= 4.0
    got = step.numbers(dict(out, h2o=h2o), ref, state)
    assert got["h2o_median"] <= limits["h2o_median"], got
    assert got["h2o_p90"] > limits["h2o_p90"], got


def _broken(out, fault):
    """The step's outputs with the fault planted: the second half of the
    columns left out (zero), or column 0's answer altered (x1.5)."""
    def one(x):
        x = x.clone() if isinstance(x, torch.Tensor) else np.array(x)
        n = x.shape[0]
        if fault == "half":
            x[n // 2:] = 0
        else:
            x[0] = x[0] * 1.5
        return x
    return tuple(one(x) for x in out)


@pytest.mark.parametrize("fault", ["sound", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_run_catches_faults(workload, fault, monkeypatch):
    spec = small_spec(workload)
    entry_mod = harness.load("entries", spec["cell"]["entry"])
    forward = entry_mod.Entry.forward
    if fault != "sound":
        monkeypatch.setattr(entry_mod.Entry, "forward",
                            lambda self, x, span: _broken(
                                forward(self, x, span), fault))
    r = harness.run_cell(workload, 2 ** 31 + 12345, 0.3, False,
                         torch.device("cpu"), time.perf_counter(), spec)
    assert r["correct"] == (fault == "sound"), r["check"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {
        "setup_s", "columns_per_s", "step_p95_ms"}


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("rte_rrtmgp_tpu", True), ("rte_rrtmgp_tpu.ops", True),
    ("rte_rrtmgp_tpu_torch", False), ("jaxtyping", False)])
def test_forbidden_modules_by_whole_top_level_name(name, found, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) == found


def test_run_holding_jax_gives_no_result(monkeypatch):
    spec = small_spec("rfmip.fused.fwd")
    assert harness.forbidden_modules() == []
    entry_mod = harness.load("entries", spec["cell"]["entry"])
    forward = entry_mod.Entry.forward

    def loads_jax(self, x, span):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return forward(self, x, span)
    monkeypatch.setitem(sys.modules, "jax", None)
    del sys.modules["jax"]
    monkeypatch.setattr(entry_mod.Entry, "forward", loads_jax)
    with pytest.raises(RuntimeError, match="JAX package.*: jax$"):
        harness.run_cell("rfmip.fused.fwd", 2 ** 31 + 12345, 0.3, False,
                         torch.device("cpu"), time.perf_counter(), spec)
