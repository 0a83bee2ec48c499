"""Runtime configuration: the working dtype, the value-check toggle and
the default device.

Mirrors the reference's precision switch (``RTE_USE_SP``,
rte/kernels/mo_rte_kind.F90:24-41) and its ``check_values`` toggle
(rte/frontend/mo_rte_config.F90:20-51). There is no kernel switch:
kernels are chosen by the device a tensor lives on, and the entry points
that make tensors put them on the CUDA device unless told otherwise.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

__all__ = ["RTEConfig", "get_config", "checks_disabled", "check_dtype",
           "resolve_device"]

_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass
class RTEConfig:
    # eager range checks on inputs (cloud particle sizes, water paths);
    # each costs one device -> host read (the cloud check none right after
    # a pass on the same, unchanged tensors)
    check_values: bool = True


_CONFIG = RTEConfig()


def get_config() -> RTEConfig:
    return _CONFIG


@contextmanager
def checks_disabled():
    """Temporarily skip the value checks (the reference benchmark's
    timed-loop setting, rrtmgp_allsky.F90:332-335)."""
    prev = _CONFIG.check_values
    _CONFIG.check_values = False
    try:
        yield
    finally:
        _CONFIG.check_values = prev


def check_dtype(dtype) -> torch.dtype:
    """The working dtype must be float32 (the kernels' type) or float64
    (CPU validation against the f64 goldens)."""
    if dtype not in _DTYPES:
        raise ValueError(f"working dtype must be float32 or float64, got {dtype}")
    return dtype


def resolve_device(device) -> torch.device:
    """The device an entry point builds its tensors on: ``None`` means the
    current CUDA device, and raises when there is none (the CPU is used
    only when asked for, e.g. ``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to build "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
