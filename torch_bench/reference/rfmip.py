"""The RFMIP configuration's plain reference: clear-sky LW and SW fluxes
of one state (the example's rrtmgp_rfmip_lw.F90 and rrtmgp_rfmip_sw.F90),
the SW incident flux scaled to each column's TSI, night columns solved
with mu0 = 1 and zeroed."""
from __future__ import annotations

import math

import torch

from torch_bench.reference import rrtmgp as R

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn")


def day_columns(sza32: torch.Tensor) -> torch.Tensor:
    """Columns with the sun up: sza below 90 degrees less two float32
    epsilons of 90 (rrtmgp_rfmip_sw.F90:272-283), read on the float32
    angles the program gets."""
    return sza32 < 90.0 - 2.0 * torch.finfo(torch.float32).eps * 90.0


def forward(data: dict, state: dict, dtype=torch.float64, device=None,
            block: int = 600):
    """(lw_up, lw_dn, sw_up, sw_dn), float64, each (ncol, nlay+1)."""
    device = device or state["play"].device
    lw = R.KTables(data["lw"], dtype, device)
    sw = R.KTables(data["sw"], dtype, device)
    c = lambda x: x.to(device=device, dtype=dtype)
    out = []
    for i in range(0, state["play"].shape[0], block):
        b = slice(i, i + block)
        play, plev, tlay, tlev = (c(state[k][b]) for k in ("play", "plev",
                                                            "tlay", "tlev"))
        vmr = {g: c(v[b]) for g, v in state["gases"].items()}
        tau, (lay, lev, sfc) = R.gas_lw(lw, play, plev, tlay, tlev,
                                        c(state["sfc_t"][b]), vmr)
        lw_up, lw_dn = R.lw_solve(tau, lay, lev, sfc,
                                  c(state["sfc_emis"][b])[:, None])
        tau, ssa = R.gas_sw(sw, play, plev, tlay, vmr)
        day = day_columns(state["sza"][b]).to(device)
        mu0 = torch.where(day, torch.cos(c(state["sza"][b]) * (math.pi / 180)),
                          1.0)
        inc = sw.solar[None] * (c(state["tsi"][b]) / sw.solar.sum())[:, None]
        sw_up, sw_dn, _ = R.sw_solve(tau, ssa, torch.zeros_like(tau), mu0,
                                     c(state["sfc_alb"][b])[:, None], inc)
        m = day[:, None].to(dtype)
        out.append((lw_up, lw_dn, sw_up * m, sw_dn * m))
    return tuple(torch.cat([o[i] for o in out]).double()
                 for i in range(len(OUTPUTS)))
