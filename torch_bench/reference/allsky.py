"""The all-sky configuration's plain reference: LW and SW fluxes of one
state with clouds (the example's rrtmgp_allsky.F90 step), and the
gradient step's loss and gradients, in column blocks on the device."""
from __future__ import annotations

import torch

from torch_bench.reference import rrtmgp as R

OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")


class AllSky:
    def __init__(self, data: dict, dtype, device):
        self.dtype, self.device = dtype, device
        self.lw = R.KTables(data["lw"], dtype, device)
        self.sw = R.KTables(data["sw"], dtype, device)
        self.cld_lw = R.Clouds(data["cloud_lw"], dtype, device)
        self.cld_sw = R.Clouds(data["cloud_sw"], dtype, device)

    def inputs(self, state: dict, cols: slice) -> dict:
        """The state's columns ``cols`` in the reference's dtype; the
        generator's float32 values are the program's inputs exactly."""
        c = lambda x: x.to(device=self.device, dtype=self.dtype)
        x = {k: c(state[k][cols]) for k in ("play", "plev", "tlay", "tlev",
                                             "tsfc", "h2o", "lwp", "iwp",
                                             "rel", "dei", "mu0", "sfc_emis",
                                             "sfc_alb")}
        x["vmr"] = dict(h2o=x.pop("h2o"), o3=c(state["o3"]), **{
            g: c(torch.tensor(v, dtype=torch.float32))
            for g, v in state["gases"].items()})
        return x

    def fluxes(self, x: dict):
        """(lw_up, lw_dn, sw_up, sw_dn, sw_dir), each (ncol, nlay+1)."""
        tau, (lay, lev, sfc) = R.gas_lw(self.lw, x["play"], x["plev"],
                                        x["tlay"], x["tlev"], x["tsfc"],
                                        x["vmr"])
        c = self.cld_lw.bands(x["lwp"], x["iwp"], x["rel"], x["dei"])
        tau = tau + (c[0] - c[1])[..., self.lw.gpt2band]
        lw_up, lw_dn = R.lw_solve(tau, lay, lev, sfc, x["sfc_emis"])
        tau, ssa = R.gas_sw(self.sw, x["play"], x["plev"], x["tlay"],
                            x["vmr"])
        c = self.cld_sw.bands(x["lwp"], x["iwp"], x["rel"], x["dei"])
        tau, ssa, g = R.add_clouds_sw(tau, ssa, c, self.sw.gpt2band)
        inc = self.sw.solar[None].expand(tau.shape[0], -1)
        sw_up, sw_dn, sw_dir = R.sw_solve(tau, ssa, g, x["mu0"],
                                          x["sfc_alb"], inc)
        return lw_up, lw_dn, sw_up, sw_dn, sw_dir


def _blocks(n, block):
    return [slice(i, min(i + block, n)) for i in range(0, n, block)]


def forward(data: dict, state: dict, dtype=torch.float64, device=None,
            block: int = 512):
    """The five fluxes of ``state``, float64, (ncol, nlay+1) each."""
    ref = AllSky(data, dtype, device or state["play"].device)
    out = [ref.fluxes(ref.inputs(state, b))
           for b in _blocks(state["play"].shape[0], block)]
    return tuple(torch.cat([o[i] for o in out]).double()
                 for i in range(len(OUTPUTS)))


def loss_of(fluxes):
    """The gradient step's loss: level-weighted sums of the fluxes (the
    weights 0.5 to 1.5 from top to bottom)."""
    lw_up, lw_dn, sw_up, sw_dn, sw_dir = fluxes
    w = torch.linspace(0.5, 1.5, lw_up.shape[1], dtype=lw_up.dtype,
                       device=lw_up.device)[None, :]
    return ((w * lw_up).sum() + 0.5 * (w * lw_dn).sum() + (w * sw_up).sum()
            + 0.5 * (w * sw_dn).sum() + 0.25 * sw_dir.sum())


def gradients(data: dict, state: dict, leaves, dtype=torch.float64,
              device=None, block: int = 256):
    """The loss of ``state``, its gradients with respect to ``leaves``
    (input names; ``h2o`` is the water vapour vmr) and the five fluxes,
    float64; column blocks are independent, so each block's gradient is
    its columns'."""
    ref = AllSky(data, dtype, device or state["play"].device)
    loss, grads, fluxes = 0.0, {k: [] for k in leaves}, []
    for b in _blocks(state["play"].shape[0], block):
        with torch.enable_grad():
            x = ref.inputs(state, b)
            vmr = x["vmr"]
            leaf = {}
            for k in leaves:
                src = vmr if k == "h2o" else x
                leaf[k] = src[k].detach().requires_grad_()
                src[k] = leaf[k]
            f = ref.fluxes(x)
            lb = loss_of(f)
            gs = torch.autograd.grad(lb, tuple(leaf.values()))
        loss += float(lb.detach())
        fluxes.append([v.detach().double() for v in f])
        for k, g in zip(leaves, gs):
            grads[k].append(g.double())
    return loss, {k: torch.cat(v) for k, v in grads.items()}, tuple(
        torch.cat([f[i] for f in fluxes]) for i in range(len(OUTPUTS)))
