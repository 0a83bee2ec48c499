"""The broadband flux container (reference ``ty_fluxes_broadband``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["Fluxes"]


@dataclasses.dataclass(frozen=True)
class Fluxes:
    flux_up: torch.Tensor                       # (ncol, nlev)
    flux_dn: torch.Tensor                       # (ncol, nlev)
    flux_net: torch.Tensor                      # (ncol, nlev) = dn - up
    flux_dn_dir: Optional[torch.Tensor] = None  # (ncol, nlev), SW only
