"""Gas volume-mixing-ratio store on tensors.

Counterpart of ``rte_rrtmgp_tpu.gas_concs`` (reference ``ty_gas_concs``,
rte/frontend/gas-optics-template/mo_gas_concentrations.F90:51-84): a
case-insensitive name -> VMR mapping where each entry is a scalar, a
profile ``(nlay,)`` or a field ``(ncol, nlay)``; reads broadcast to
``(ncol, nlay)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GasConcs"]


def _norm(name: str) -> str:
    return name.strip().lower()


@dataclasses.dataclass(frozen=True)
class GasConcs:
    names: tuple          # normalized gas names
    values: tuple         # tensors, one per name: (), (nlay,) or (ncol, nlay)

    @staticmethod
    def empty() -> "GasConcs":
        return GasConcs(names=(), values=())

    def set_vmr(self, name: str, vmr) -> "GasConcs":
        """A new store with ``name`` set (reference ``set_vmr``,
        mo_gas_concentrations.F90:121-240); vmr must lie in [0, 1]."""
        key = _norm(name)
        # host scalars and arrays are kept in float64 (torch would make a
        # Python float float32); the caller casts with .to(dtype)
        arr = (vmr if isinstance(vmr, torch.Tensor)
               else torch.as_tensor(np.asarray(vmr, np.float64)))
        if arr.ndim > 2:
            raise ValueError(f"set_vmr({name}): vmr must be scalar, 1-D, or 2-D")
        if bool(((arr < 0.0) | (arr > 1.0)).any()):
            raise ValueError(f"set_vmr({name}): values outside [0,1]")
        names = list(self.names)
        values = list(self.values)
        if key in names:
            values[names.index(key)] = arr
        else:
            names.append(key)
            values.append(arr)
        return GasConcs(names=tuple(names), values=tuple(values))

    def to(self, dtype=None, device=None) -> "GasConcs":
        return GasConcs(names=self.names, values=tuple(
            v.to(dtype=dtype, device=device) for v in self.values))

    def __contains__(self, name: str) -> bool:
        return _norm(name) in self.names

    def get_vmr(self, name: str, ncol: int, nlay: int) -> torch.Tensor:
        """VMR broadcast to (ncol, nlay) (reference ``get_vmr`` 2-D,
        mo_gas_concentrations.F90:331-401)."""
        key = _norm(name)
        if key not in self.names:
            raise KeyError(f"gas '{name}' not present in GasConcs")
        arr = self.values[self.names.index(key)]
        if arr.ndim == 1 and arr.shape[0] != nlay:
            raise ValueError(f"get_vmr({name}): profile has {arr.shape[0]} "
                             f"layers, expected {nlay}")
        if arr.ndim == 2 and tuple(arr.shape) != (ncol, nlay):
            raise ValueError(f"get_vmr({name}): field shape "
                             f"{tuple(arr.shape)} != {(ncol, nlay)}")
        return arr.expand(ncol, nlay)
