"""Step kind ``grid_aer``: ``grid``'s sweep and check, for a stream with
aerosols, and three numbers besides that see the aerosols, which the
fluxes' own limits (set by float32's noise) cannot: the example's
aerosols move no flux by more than about 0.4 W/m2 LW and 1.4 W/m2 SW.

  * ``lw_aer``, ``sw_aer``: the aerosols' effect on the fluxes, each
    output less the same output of the same state with its aerosol mass
    set to 0, program against reference: the largest absolute gap in
    W/m2 (LW up and down on every column; SW up, down and direct, which
    are 0 on the night columns in both). The program's massless sweep is
    the timed stream's own, run after the window.
  * ``aer_optics``: the by-band increments that the timed stream's own
    cloud and aerosol optics give the sampled state (the LW absorption,
    the clouds' and the aerosols' summed; the SW delta-scaled tau, ssa
    and g of both combined), against the reference's: the largest gap
    relative to the reference's value, over every cell and band (where
    the reference's is 0, the program's own value).

The harness frees the entry before its check and makes the checker
without one, so the step keeps the entry it last timed, module-wide, for
the check's runs of the program; a control (the reference in a lower
precision, put in the program's place) brings its own.
"""
from __future__ import annotations

import math

import torch

from torch_bench.steps import grid

# the entry of the last step made with one ("entry")
_TIMED = {}


def _f64(o, like):
    return torch.as_tensor(o).to(device=like.device, dtype=torch.float64)


def _sound(o, like) -> bool:
    return o.shape == like.shape and bool(torch.isfinite(o).all())


class Step(grid.Step):
    def __init__(self, entry, cell: dict, outputs):
        super().__init__(entry, cell, outputs)
        self.names = self.names + ("lw_aer", "sw_aer", "aer_optics")
        if entry is not None:
            _TIMED["entry"] = entry

    def reference(self, refmod, data: dict, state: dict,
                  dtype=torch.float64):
        """``grid``'s fluxes of the state, of the state without aerosol
        mass, and the state's increments by band."""
        massless = dict(state, aero_mass=torch.zeros_like(state["aero_mass"]))
        return dict(fluxes=super().reference(refmod, data, state, dtype),
                    massless=super().reference(refmod, data, massless, dtype),
                    increments=refmod.increments(data, state, dtype))

    def program(self, out, state: dict) -> dict:
        """The timed sweep's fluxes ``out`` and the timed entry's own runs
        on the state, in :meth:`reference`'s form."""
        entry = _TIMED["entry"]
        massless = dict(state, aero_mass=torch.zeros_like(state["aero_mass"]))
        return dict(fluxes=out, massless=entry.sweep(massless),
                    increments=entry.increments(state))

    def numbers(self, out, ref, state) -> dict:
        """``grid``'s numbers, and the three above (inf where an output is
        not finite or not of the reference's shape)."""
        if not isinstance(out, dict):
            out = self.program(out, state)
        got = super().numbers(out["fluxes"], ref["fluxes"], state)
        for name, which in (("lw_aer", (0, 1)), ("sw_aer", (2, 3, 4))):
            gap = 0.0
            for j in which:
                r = ref["fluxes"][j] - ref["massless"][j]
                o = [_f64(d[j], r) for d in (out["fluxes"], out["massless"])]
                if not all(_sound(x, r) for x in o):
                    gap = math.inf
                    break
                gap = max(gap, float((o[0] - o[1] - r).abs().max()))
            got[name] = gap
        gap = 0.0
        for o, r in zip(out["increments"], ref["increments"]):
            o = _f64(o, r)
            if not _sound(o, r):
                gap = math.inf
                break
            d = (o - r).abs()
            gap = max(gap, float(torch.where(r != 0, d / r.abs(), d).max()))
        got["aer_optics"] = gap
        return got

    diagnostics = numbers
