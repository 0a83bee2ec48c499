"""Step kind ``grid``: one sweep of a whole grid (the entry's call) on the
next grid of the pool, SW on the day columns alone. The check holds
each flux output against the configuration's reference by its largest
absolute gap over the grid, in W/m2: LW on every column; SW on the day
columns (``mu0 > 0``), each column the reference's fluxes of that
column, and exactly 0 on the night ones; and ``sw_night``, the largest
|program SW flux| over the night columns, whose limit is 0."""
from __future__ import annotations

import torch


class Step:
    def __init__(self, entry, cell: dict, outputs):
        self.entry = entry
        self.outputs = tuple(outputs)
        self.names = self.outputs + ("sw_night",)

    def run(self, k: int, span):
        return self.entry.forward(self.entry.inputs[k], span)

    def reference(self, refmod, data: dict, state: dict, dtype=torch.float64):
        """The reference's fluxes of every column, SW set to 0 on the
        night columns. The reference solves each column alone, so the
        night columns are solved at mu0 = 1 in the same call and their
        SW dropped: the day columns' SW is that of the day columns'
        sub-state."""
        day = state["mu0"] > 0
        lit = dict(state, mu0=torch.where(day, state["mu0"], 1.0))
        fluxes = refmod.forward(data, lit, dtype)
        night = ~day.to(fluxes[0].device)[:, None]
        return fluxes[:2] + tuple(torch.where(night, 0.0, f)
                                  for f in fluxes[2:])

    def numbers(self, out, ref, state) -> dict:
        """The largest |program - reference| of each output, and of the
        program's SW outputs over the night columns (inf where an output
        is not finite or not of the reference's shape)."""
        got, lit_at_night = {}, 0.0
        night = (state["mu0"] <= 0).to(ref[0].device)
        for name, o, r in zip(self.outputs, out, ref):
            o = torch.as_tensor(o).to(device=r.device, dtype=torch.float64)
            ok = o.shape == r.shape and bool(torch.isfinite(o).all())
            got[name] = float((o - r).abs().max()) if ok else float("inf")
            if name.startswith("sw_"):
                if not ok:
                    lit_at_night = float("inf")
                elif bool(night.any()):
                    lit_at_night = max(lit_at_night,
                                       float(o[night].abs().max()))
        got["sw_night"] = lit_at_night
        return got

    diagnostics = numbers
