"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher (pointers and the
stream as ``void*``, sizes as ``int``) that returns ``cudaGetLastError()``.
It is compiled for ``sm_90a`` into ``csrc/build/<name>.<hash>.so``, the
hash taken over the flags, the source and the shared headers, so a stale
library is never loaded. Nothing is compiled when this module is
imported: :func:`build_all` compiles every source in parallel, and
:func:`library` builds one on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import torch

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "build_all", "ptxas_usage",
           "library", "on_cpu", "check_args", "check_strided", "strided",
           "launch", "query"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("cloud_props", "fused_lw", "fused_sw", "gas_major", "gas_minor",
           "solver_lw", "solver_lw_2str", "solver_sw", "fused_lw_bwd",
           "fused_sw_bwd", "solver_lw_bwd", "solver_sw_bwd", "minor_scale",
           "gas_descriptors", "aerosol_props")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}      # name -> loaded ctypes.CDLL (one per process)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    """Library path keyed by the flags, the source and the shared headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}.{digest}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every source not yet built, one nvcc process per source,
    all started together. Returns {name: ptxas report}; raises with the
    compiler output if any build fails."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def ptxas_usage(report: str) -> list:
    """[(registers, spill store bytes, spill load bytes)] per kernel
    instantiation in a :func:`build_all` report (``-Xptxas -v``)."""
    out, spills = [], (0, 0)
    for line in report.splitlines():
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((int(m.group(1)),) + spills)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_target(name))
        _LIBS[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        lib.rte_error_string.restype = ctypes.c_char_p
        lib.rte_error_string.argtypes = [ctypes.c_int]
        msg = lib.rte_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} at launch: {msg}")


def on_cpu(t: torch.Tensor, what: str) -> bool:
    """The wrappers' dispatch: True for a CPU tensor (run the plain twin),
    False for a CUDA one (launch the kernel); any other device raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cpu"
    raise ValueError(f"{what}: tensors on {t.device}; the kernel takes CUDA "
                     "tensors and its plain twin CPU ones")


def check_args(what: str, device, specs: dict,
               contiguous: bool = True) -> None:
    """specs: {name: (tensor, shape, dtype)}. The kernels take tensors of
    exactly these shapes and dtypes (float32 data, int32 indices) on one
    CUDA device, contiguous unless told otherwise; raise on anything
    else."""
    for name, (t, shape, dtype) in specs.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}; the CUDA "
                             f"kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def check_strided(what: str, device, specs: dict) -> None:
    """:func:`check_args` for the kernels that read through element
    strides: any strides (permuted or broadcast views included) as long as
    every offset fits the kernels' 32-bit strides. A None tensor is
    skipped."""
    specs = {k: v for k, v in specs.items() if v[0] is not None}
    check_args(what, device, specs, contiguous=False)
    for name, (t, _, _) in specs.items():
        last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        if last >= 2 ** 31:
            raise ValueError(f"{what}: {name} spans {last + 1} elements, "
                             "more than 32-bit strides reach")


def strided(t, ndim: int) -> tuple:
    """A tensor and its element strides as launcher arguments; None and
    ``ndim`` zero strides for an absent one."""
    if t is None:
        return (None,) + (0,) * ndim
    return (t,) + tuple(t.stride())


def launch(name: str, fn: str, what: str, *args) -> None:
    """Call launcher ``fn`` of library ``name`` on the current stream of
    the first tensor's device. Tensors pass as ``void*`` (None as a null
    pointer), Python ints as ``int``, floats as ``float``, ctypes arrays
    (host data the launcher reads) as a pointer to their first element;
    the stream is appended last. The tensors' device is the current one
    during the call, and the caller's is restored after it."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    types, vals = [], []
    for a in args:
        if isinstance(a, torch.Tensor) or a is None:
            types.append(ctypes.c_void_p)
            vals.append(None if a is None else a.data_ptr())
        elif isinstance(a, int):
            types.append(ctypes.c_int)
            vals.append(int(a))
        elif isinstance(a, float):
            types.append(ctypes.c_float)
            vals.append(a)
        elif isinstance(a, ctypes.Array):
            types.append(ctypes.c_void_p)
            vals.append(ctypes.addressof(a))
        else:
            raise TypeError(f"{what}: cannot pass {type(a).__name__} to {fn}")
    types.append(ctypes.c_void_p)
    vals.append(torch.cuda.current_stream(dev).cuda_stream)
    lib = library(name)
    f = getattr(lib, fn)
    f.argtypes = types
    f.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = f(*vals)
    check_status(lib, status, what)


def query(name: str, fn: str, *ints: int) -> int:
    """Call ``fn(int, ...) -> int`` of library ``name``: the kernels'
    resident blocks per SM (``occupancy_*``, a negative CUDA error on
    failure)."""
    f = getattr(library(name), fn)
    f.argtypes = [ctypes.c_int] * len(ints)
    f.restype = ctypes.c_int
    return f(*ints)
