"""Row 17, ``csrc/fused_sw_bwd.cu`` (``fused_sw_bwd_kernel``): one launch
per step of the fused all-sky gradient step. Operations per cell and
g-point: the forward's major corners (5) with their cotangents (14), the
Rayleigh lerp and its adjoint (18 + 12), the combine and cloud increment
and their adjoint (12 + 30), the coefficients, beam and adding
recomputed with their adjoints and the Meador-Weaver chain transposed
(300); per (cell, g-point) a minor window covers, 16 + 12. Bytes: the
forward's inputs, the three flux cotangents, and the cotangents of the
differentiable inputs written once; the kernel's own scratch is not
counted."""
from torch_bench.harness import load

OPS_MAJOR_ADJ_CORNER = 14
OPS_RAYLEIGH_ADJ = 12
OPS_COMBINE_ADJ = 30
OPS_SW_ADJ = 300
OPS_MINOR_ADJ = 12


def work(s, cell=None):
    fwd = load("work", "fused_sw")
    ncol, nlay, g = s["ncol"], s["nlay"], s["ngpt_sw"]
    ncell, nlev = ncol * nlay, nlay + 1
    ops = ncell * (g * (8 * (fwd.OPS_MAJOR_CORNER + OPS_MAJOR_ADJ_CORNER)
                        + fwd.OPS_RAYLEIGH + OPS_RAYLEIGH_ADJ
                        + fwd.OPS_SW_COMBINE + OPS_COMBINE_ADJ + OPS_SW_ADJ)
                   + fwd.covered(s, "sw") * (fwd.OPS_MINOR + OPS_MINOR_ADJ))
    nminor = (len(s["minor_widths_sw_lower"])
              + len(s["minor_widths_sw_upper"]))
    cot_in = 3 * nlev * ncol * 4
    cot_out = (2 * ncell + 2 * 2 * s["nflav_sw"] * ncell + nminor * ncell
               + ncell + (3 * s["nbnd_sw"] * ncell if s["clouds"] else 0)
               + ncell + 4 * g * ncol) * 4
    return fwd.inputs_bytes(s) + cot_in + cot_out, ops
