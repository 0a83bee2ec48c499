"""The all-sky problem's inputs (configurations with ``"problem":
"allsky"``): one pool state of the reference's all-sky example, drawn by
:func:`state`. It brings no tables past the generator's shared
k-distribution and cloud tables, and no sizes past ``generator.shapes``.
"""
from __future__ import annotations

import torch

from torch_bench.traffic.generator import TRACE, VMR, Draw, column


def state(config: dict, traffic: dict, draw: Draw) -> dict:
    """One all-sky state: the example's atmosphere (clouds between 100 and
    900 hPa, liquid above 263 K, ice below 273 K), each column warmer or
    colder by up to ``dT`` K and moister or drier by a factor in
    ``h2o_scale``, a fixed share of the columns cloudy (which ones drawn),
    water paths, particle sizes and the sun drawn in the given ranges."""
    ncol, nlay = config["ncol"], config["nlay"]
    t = traffic
    dev = draw.device
    play, plev, tlay, tlev, q, o3 = column(nlay, 300.0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    dT = draw.uniform((ncol, 1), -t["dT"], t["dT"])
    h2o = f32(q)[None] * draw.uniform((ncol, 1), *t["h2o_scale"])
    cloudy = torch.zeros(ncol, dtype=torch.bool, device=dev)
    cloudy[draw.perm(ncol)[:round(t["cloudy_share"] * ncol)]] = True
    tl = f32(tlay)[None] + dT
    in_layer = ((f32(play) > 100e2) & (f32(play) < 900e2))[None] \
        & cloudy[:, None]
    liq = in_layer & (tl > 263.0)
    ice = in_layer & (tl < 273.0)
    zero = torch.zeros((), device=dev)
    lwp = torch.where(liq, draw.uniform((ncol, nlay), *t["lwp"]), zero)
    iwp = torch.where(ice, draw.uniform((ncol, nlay), *t["iwp"]), zero)
    return dict(
        play=f32(play)[None].expand(ncol, nlay).contiguous(),
        plev=f32(plev)[None].expand(ncol, nlay + 1).contiguous(),
        tlay=tl.contiguous(), tlev=(f32(tlev)[None] + dT).contiguous(),
        tsfc=(300.0 + dT[:, 0]).contiguous(), h2o=h2o.contiguous(),
        o3=f32(o3), lwp=lwp, iwp=iwp,
        rel=torch.where(liq, draw.uniform((ncol, nlay), *t["rel"]), zero),
        dei=torch.where(ice, draw.uniform((ncol, nlay), *t["dei"]), zero),
        mu0=draw.uniform((ncol,), *t["mu0"]),
        sfc_emis=torch.full((ncol, 1), config["sfc_emis"], device=dev),
        sfc_alb=torch.full((ncol, 1), config["sfc_alb"], device=dev),
        gases=dict(co2=348.0e-6, ch4=1650.0e-9, n2o=306.0e-9, n2=0.7808,
                   o2=0.2095, co=0.0, **{g: VMR[g] for g in TRACE}))
