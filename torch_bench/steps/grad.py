"""Step kind ``grad``: the entry's forward on fresh leaves of the next
state (``cell["leaves"]``), a weighted flux loss (level weights 0.5 to
1.5 from top to bottom: up fluxes 1, down fluxes 0.5, the SW direct
beam 0.25 unweighted) and ``torch.autograd.grad`` of it, as a user who
tunes a parameterization takes it.

The check holds the step's fluxes against the reference's by their
largest gap (W/m2), the loss by its relative gap, and each gradient
against the reference's float64 autograd by its relative L1 gap,
sum |g - g_ref| / sum |g_ref|. The interpolation's gradient is piecewise
constant between table nodes, so at the few cells that sit at a node in
one precision and not in the other the two read different one-sided
derivatives: such cells carry little of an L1 sum, and would carry most
of a largest-element or an L2 gap. The water vapour's gradient is not
resolved in float32 even so (its L1 gap reads half the bfloat16
control's): it is held by the median and the 90th percentile over cells
of |g - g_ref| / |g_ref| where the state's vmr is at least
``check["h2o_min_vmr"]`` (at the RCEMIP stratospheric floor, 1.6e-14,
float32 does not resolve it, in the program and in the reference
alike); the percentile fails a fault on a tenth of the cells or more,
which the median cannot see.
"""
from __future__ import annotations

import torch


def loss_of(fluxes):
    lw_up, lw_dn, sw_up, sw_dn, sw_dir = fluxes
    w = torch.linspace(0.5, 1.5, lw_up.shape[1], dtype=lw_up.dtype,
                       device=lw_up.device)[None, :]
    return ((w * lw_up).sum() + 0.5 * (w * lw_dn).sum() + (w * sw_up).sum()
            + 0.5 * (w * sw_dn).sum() + 0.25 * sw_dir.sum())


class Step:
    def __init__(self, entry, cell: dict, outputs):
        self.entry = entry
        self.outputs = tuple(outputs)
        self.leaves = tuple(cell["leaves"])
        self.h2o_min = cell["check"].get("h2o_min_vmr", 0.0)
        self.names = (("loss",) + sum(((k,) if k != "h2o" else
                                        ("h2o_median", "h2o_p90")
                                        for k in self.leaves), ())
                      + self.outputs)

    def run(self, k: int, span):
        with span("leaves"):
            x, leaves = self.entry.with_leaves(self.entry.inputs[k],
                                               self.leaves)
        out = self.entry.forward(x, span)
        with span("loss"):
            loss = loss_of(out)
        with span("backward"):
            grads = torch.autograd.grad(loss, tuple(leaves.values()))
        return dict(loss=loss.detach(), **dict(zip(self.leaves, grads)),
                    **{n: f.detach() for n, f in zip(self.outputs, out)})

    def reference(self, refmod, data: dict, state: dict, dtype=torch.float64):
        loss, grads, fluxes = refmod.gradients(data, state, self.leaves,
                                               dtype)
        return dict(loss=torch.tensor(loss, dtype=torch.float64), **grads,
                    **dict(zip(self.outputs, fluxes)))

    def _pair(self, out, ref, k, state):
        r = ref[k].double()
        o = torch.as_tensor(out[k]).to(device=r.device, dtype=torch.float64)
        ok = o.shape == r.shape and bool(torch.isfinite(o).all())
        return o, r, ok

    def _quantiles(self, o, r, state):
        keep = (state["h2o"].to(r.device) >= self.h2o_min) & (r != 0)
        rel = ((o - r).abs()[keep] / r.abs()[keep]).float()
        q = torch.quantile(rel.cpu(), torch.tensor([0.5, 0.9]))
        return float(q[0]), float(q[1])

    def numbers(self, out, ref, state=None) -> dict:
        """See the module's notes; inf where the program's value is not
        finite or not of the reference's shape."""
        got = {}
        for k in ("loss",) + self.leaves + self.outputs:
            o, r, ok = self._pair(out, ref, k, state)
            if k == "h2o":
                got["h2o_median"], got["h2o_p90"] = (
                    self._quantiles(o, r, state) if ok
                    else (float("inf"), float("inf")))
            elif not ok:
                got[k] = float("inf")
            elif k == "loss":
                got[k] = float((o - r).abs() / r.abs())
            elif k in self.leaves:
                got[k] = float((o - r).abs().sum() / r.abs().sum())
            else:
                got[k] = float((o - r).abs().max())
        return got

    def diagnostics(self, out, ref, state=None) -> dict:
        """:meth:`numbers` and, per leaf, the relative L2 gap, the largest
        element gap over the largest reference element, the gap of the
        2-norms and, for h2o, the L1 gap where the vmr is at least
        ``h2o_min_vmr``."""
        got = self.numbers(out, ref, state)
        for k in self.leaves:
            o, r, ok = self._pair(out, ref, k, state)
            if not ok:
                continue
            d = o - r
            got[k + ".l2"] = float(d.norm() / r.norm())
            got[k + ".maxrel"] = float(d.abs().max() / r.abs().max())
            got[k + ".normgap"] = float((o.norm() - r.norm()).abs()
                                        / r.norm())
            if k == "h2o":
                keep = state["h2o"].to(r.device) >= self.h2o_min
                got["h2o.l1"] = float(d.abs()[keep].sum()
                                      / r.abs()[keep].sum())
        return got
