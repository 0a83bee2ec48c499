"""Step kind ``fwd``: one call of the entry on the next state of the
pool; the check holds each flux output against the configuration's
reference by its largest absolute gap, in W/m2."""
from __future__ import annotations

import torch


class Step:
    def __init__(self, entry, cell: dict, outputs):
        self.entry = entry
        self.names = tuple(outputs)

    def run(self, k: int, span):
        return self.entry.forward(self.entry.inputs[k], span)

    def reference(self, refmod, data: dict, state: dict, dtype=torch.float64):
        return refmod.forward(data, state, dtype)

    def numbers(self, out, ref, state=None) -> dict:
        """The largest |program - reference| of each output (inf where
        the program's output is not finite or not of the reference's
        shape)."""
        got = {}
        for name, o, r in zip(self.names, out, ref):
            o = torch.as_tensor(o).to(device=r.device, dtype=torch.float64)
            ok = o.shape == r.shape and bool(torch.isfinite(o).all())
            got[name] = float((o - r).abs().max()) if ok else float("inf")
        return got

    diagnostics = numbers
