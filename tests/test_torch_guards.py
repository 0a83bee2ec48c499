"""Guards for the port's rules.

  * The port and chip_smoke.py import no JAX: the machine with the GPU
    has none. Checked in a fresh interpreter where ``import jax`` fails.
  * chip_smoke.py has no CPU path: without a CUDA device it exits
    non-zero and prints no result.
  * The CUDA wrappers refuse what their kernels do not take, and a
    missing compiler raises rather than falling back.
"""
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
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
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


@pytest.mark.parametrize("name", ["cloud_props", "lw_fused", "sw_fused"])
def test_wrappers_refuse_other_devices(name):
    """Dispatch goes by device: a CPU tensor runs the twin, a CUDA one the
    kernel, and a tensor on any other device raises instead of reaching
    the twin."""
    from rte_rrtmgp_tpu_torch.ops.kernels import cloud_props, fused_lw, fused_sw
    meta = torch.empty((2, 3), device="meta")
    if name == "cloud_props":
        call = lambda: cloud_props.cloud_props(meta, meta, meta, meta, meta)
    elif name == "lw_fused":
        x = fused_lw.LWFusedInputs(*[None] * len(fused_lw.LWFusedInputs._fields))
        call = lambda: fused_lw.lw_fused(x._replace(tlay=meta))
    else:
        x = fused_sw.SWFusedInputs(*[None] * len(fused_sw.SWFusedInputs._fields))
        call = lambda: fused_sw.sw_fused(x._replace(mu0=meta))
    with pytest.raises(ValueError, match="on meta"):
        call()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from rte_rrtmgp_tpu_torch.ops.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
