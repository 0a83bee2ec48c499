"""Guards for the port's rules.

  * The port and chip_smoke.py import no JAX and nothing of the JAX
    package: the machine with the GPU has none. Checked in a fresh
    interpreter where ``import jax`` fails, and in the sources.
  * chip_smoke.py has no CPU path: without a CUDA device it exits
    non-zero and prints no result.
  * The entry points that build tensors default to the CUDA device and,
    without one, raise; the CPU is used only when asked for.
  * The CUDA wrappers refuse what their kernels do not take, and a
    missing compiler raises rather than falling back.
"""
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "rte_rrtmgp_tpu_torch"


def _port_modules():
    import rte_rrtmgp_tpu_torch as pkg
    return [PKG] + [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                          PKG + ".")]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    mods = _port_modules()
    assert len(mods) > 15
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', "
            "'rte_rrtmgp_tpu.')) for k in sys.modules if sys.modules[k])\n"
            "print('ok')")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_jax_in_port_sources():
    pattern = re.compile(r"^\s*(import|from) (jax|rte_rrtmgp_tpu(?!_torch))\b",
                         re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, PKG)):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert not pattern.search(fh.read()), f


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_check_args_refuses_what_kernels_do_not_take():
    from rte_rrtmgp_tpu_torch.ops.kernels._build import check_args
    dev = torch.device("cpu")
    good = torch.zeros((2, 3))
    check_args("k", dev, {"x": (good, (2, 3), torch.float32)})
    cases = {
        "dtype": (good.double(), (2, 3), torch.float32),
        "shape": (good, (3, 2), torch.float32),
        "contiguous": (torch.zeros((3, 2)).T, (2, 3), torch.float32),
        "is on": (good, (2, 3), torch.float32),
    }
    for what, spec in cases.items():
        device = torch.device("meta") if what == "is on" else dev
        with pytest.raises(ValueError, match=what):
            check_args("k", device, {"x": spec})


WRAPPERS = ["cloud_props", "lw_fused", "sw_fused", "gas_major", "gas_minor",
            "gas_rayleigh", "lw_noscat", "sw_2stream", "lw_2stream"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_other_devices(name):
    """Dispatch goes by device: a CPU tensor runs the twin, a CUDA one the
    kernel, and a tensor on any other device raises instead of reaching
    the twin."""
    from rte_rrtmgp_tpu_torch.ops.gas_optics import InterpCoeffs
    from rte_rrtmgp_tpu_torch.ops.kernels import (cloud_props, fused_lw,
                                                  fused_sw, gas_major,
                                                  gas_minor, solver_lw,
                                                  solver_lw_2str, solver_sw)
    meta = torch.empty((2, 3), device="meta")
    co = InterpCoeffs(*[meta] * len(InterpCoeffs._fields))
    calls = {
        "cloud_props": lambda: cloud_props.cloud_props(*[meta] * 5),
        "lw_fused": lambda: fused_lw.lw_fused(fused_lw.LWFusedInputs(
            *[None] * len(fused_lw.LWFusedInputs._fields))._replace(
                tlay=meta)),
        "sw_fused": lambda: fused_sw.sw_fused(fused_sw.SWFusedInputs(
            *[None] * len(fused_sw.SWFusedInputs._fields))._replace(
                mu0=meta)),
        "gas_major": lambda: gas_major.gas_major(co, meta, None, meta),
        "gas_minor": lambda: gas_minor.gas_minor(meta, co, meta, (), meta,
                                                 meta),
        "gas_rayleigh": lambda: gas_minor.gas_rayleigh(meta, co, meta, meta,
                                                       meta),
        "lw_noscat": lambda: solver_lw.lw_noscat(*[meta] * 6, ds=1.0,
                                                 weight=1.0),
        "sw_2stream": lambda: solver_sw.sw_2stream(*[meta] * 7),
        "lw_2stream": lambda: solver_lw_2str.lw_2stream(*[meta] * 8),
    }
    with pytest.raises(ValueError, match="on meta"):
        calls[name]()


def _entry_points():
    from rte_rrtmgp_tpu_torch import convert
    from rte_rrtmgp_tpu_torch.drivers import allsky
    from rte_rrtmgp_tpu_torch.models.rrtmgp.cloud_optics import (
        CloudOpticsRRTMGP)
    from rte_rrtmgp_tpu_torch.models.rrtmgp.kdist import KDist
    from rte_rrtmgp_tpu_torch.utils import synthetic
    return {
        "synthetic_kdist": (synthetic.synthetic_kdist, lambda f: f(
            ngpt=8, nbnd=2, ntemp=4, npres=5)),
        "synthetic_cloud_optics": (synthetic.synthetic_cloud_optics,
                                   lambda f: f(nbnd=2)),
        "make_allsky_inputs": (allsky.make_allsky_inputs,
                               lambda f: f(4, 6)),
        "KDist.from_raw": (KDist.from_raw, lambda f: f(
            synthetic.GASES_FULL, **synthetic.synthetic_kdist_raw(
                ngpt=8, nbnd=2, ntemp=4, npres=5))),
        "CloudOpticsRRTMGP.load": (CloudOpticsRRTMGP.load, lambda f: f(
            **synthetic.synthetic_cloud_raw(nbnd=2))),
        "kdist_from_jax": (convert.kdist_from_jax, lambda f: f(object())),
        "cloud_optics_from_jax": (convert.cloud_optics_from_jax,
                                  lambda f: f(object())),
    }


ENTRY_POINTS = ["synthetic_kdist", "synthetic_cloud_optics",
                "make_allsky_inputs", "KDist.from_raw",
                "CloudOpticsRRTMGP.load", "kdist_from_jax",
                "cloud_optics_from_jax"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_cuda(name):
    """Each entry point that builds tensors takes device=None, meaning the
    CUDA device; without one it raises and does not build on the CPU."""
    fn, call = _entry_points()[name]
    default = inspect.signature(fn).parameters["device"].default
    assert default is None and default != "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device error cannot "
                    "be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(fn)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from rte_rrtmgp_tpu_torch.ops.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
