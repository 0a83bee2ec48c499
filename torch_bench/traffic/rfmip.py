"""The RFMIP problem's inputs (configurations with ``"problem":
"rfmip"``): one pool state of RFMIP-IRF clear sky, drawn by
:func:`state`. It brings no tables past the generator's shared
k-distribution tables, and no sizes past ``generator.shapes``.
"""
from __future__ import annotations

import torch

from torch_bench.traffic.generator import TRACE, VMR, Draw, column


def state(config: dict, traffic: dict, draw: Draw) -> dict:
    """One RFMIP state: RCEMIP sites (each warmer or colder by up to
    ``dT`` K and moister or drier by a factor in ``h2o_scale``), repeated
    for every experiment, which scale CO2, CH4 and N2O; each column's TSI
    and solar zenith angle drawn in the configuration's ranges. Every
    field (ncol, nlay[+1]) with column = experiment * nsite + site."""
    nsite, nexp, nlay = config["nsite"], config["nexp"], config["nlay"]
    ncol = nsite * nexp
    t = traffic
    dev = draw.device
    play, plev, tlay, tlev, q, o3 = column(nlay, 295.0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    dT = draw.uniform((nsite, 1), -t["dT"], t["dT"])
    hs = draw.uniform((nsite, 1), *t["h2o_scale"])
    rep = lambda x: x.repeat(nexp, 1).contiguous()
    tl = rep(f32(tlay)[None] + dT)
    scale = torch.linspace(*config["ghg_scale"], nexp, device=dev)
    per_exp = lambda base: (base * scale).repeat_interleave(nsite)[:, None] \
        .expand(ncol, nlay).contiguous()
    const = lambda v: torch.full((ncol, nlay), v, device=dev)
    return dict(
        play=rep(f32(play)[None].expand(nsite, nlay)),
        plev=rep(f32(plev)[None].expand(nsite, nlay + 1)),
        tlay=tl, tlev=rep(f32(tlev)[None] + dT), sfc_t=tl[:, -1].contiguous(),
        sfc_emis=torch.full((ncol,), config["sfc_emis"], device=dev),
        sfc_alb=torch.full((ncol,), config["sfc_alb"], device=dev),
        tsi=draw.uniform((ncol,), *config["tsi_range"]),
        sza=draw.uniform((ncol,), *config["sza_range"]),
        gases=dict(h2o=rep(f32(q)[None] * hs),
                   o3=rep(f32(o3)[None].expand(nsite, nlay)),
                   co2=per_exp(348e-6), ch4=per_exp(1650e-9),
                   n2o=per_exp(306e-9), o2=const(0.209), n2=const(0.781),
                   co=const(1.5e-7), **{g: const(VMR[g]) for g in TRACE}))
