"""Row 16, ``csrc/fused_lw_bwd.cu`` (``fused_lw_bwd_kernel``): one launch
per step of the fused all-sky gradient step. Operations per cell and
g-point: the forward's major corners and Planck fraction (7 per corner)
with their five cotangents (14 per corner), the totplnk lerps (12), the
layer terms recomputed and the sweeps' and sources' adjoints (70); per
(cell, g-point) a minor window covers, its forward (16) and adjoint (12).
Bytes: the forward's inputs (kmajor and the Planck fraction as two
tables), the two flux cotangents, and the cotangents of the
differentiable inputs written once (descriptor fractions, col_mix, minor
scaling, temperatures, boundary fields, the clouds' absorption); the
kernel's own scratch is not the function's and is not counted."""
from torch_bench.harness import load

OPS_MAJOR_ADJ_CORNER = 14
OPS_LW_ADJ = 70
OPS_MINOR_ADJ = 12


def work(s, cell=None):
    fwd = load("work", "fused_lw")
    ncol, nlay, g = s["ncol"], s["nlay"], s["ngpt_lw"]
    ncell, nlev = ncol * nlay, nlay + 1
    ops = ncell * (g * (8 * (fwd.OPS_MAJOR_CORNER + fwd.OPS_PFRAC_CORNER
                             + OPS_MAJOR_ADJ_CORNER) + fwd.OPS_PLANCK
                        + OPS_LW_ADJ)
                   + fwd.covered(s, "lw") * (fwd.OPS_MINOR + OPS_MINOR_ADJ))
    tables = 2 * s["ntemp"] * s["neta"] * (s["npres"] + 1) * g * 4
    nminor = (len(s["minor_widths_lw_lower"])
              + len(s["minor_widths_lw_upper"]))
    cot_in = 2 * nlev * ncol * 4
    cot_out = (2 * ncell + 2 * 2 * s["nflav_lw"] * ncell + nminor * ncell
               + ncell + nlev * ncol + ncol + 2 * g * ncol
               + (s["nbnd_lw"] * ncell if s["clouds"] else 0)) * 4
    return fwd.inputs_bytes(s, tables) + cot_in + cot_out, ops
