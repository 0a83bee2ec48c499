"""Row 3, ``csrc/fused_sw.cu`` (``fused_sw_kernel``): one launch per step
of the fused all-sky and RFMIP forward steps. Operations per cell and
g-point: 8 corners of the major lookup (5 each), Rayleigh (2-D lerp,
scale, combine: 18), the Rayleigh and cloud combine (12), Meador-Weaver,
the direct beam and adding (62); 16 per (cell, g-point) a minor window
covers. Bytes: each input read once, each output written once: kmajor,
krayl, the minor tables, the descriptors, the minor scaling rows, the
Rayleigh scale, the clouds' delta-scaled (tau, ssa, g) by band, mu0, the
boundary fields, three flux fields."""
OPS_MAJOR_CORNER = 5
OPS_RAYLEIGH = 18
OPS_SW_COMBINE = 12
OPS_SW_LAYER = 62
OPS_MINOR = 16


def covered(s, side):
    return (sum(s[f"minor_widths_{side}_lower"])
            + sum(s[f"minor_widths_{side}_upper"]))


def inputs_bytes(s):
    ncol, nlay, g = s["ncol"], s["nlay"], s["ngpt_sw"]
    ncell = ncol * nlay
    nminor = (len(s["minor_widths_sw_lower"])
              + len(s["minor_widths_sw_upper"]))
    t = s["ntemp"] * s["neta"]
    tables = (t * (s["npres"] + 1) * g + t * g * 2 + t * covered(s, "sw")) * 4
    descr = 5 * ncell * 4 + 3 * 2 * s["nflav_sw"] * ncell * 4
    cloud = 3 * s["nbnd_sw"] * ncell * 4 if s["clouds"] else 0
    fields = (ncell + ncell + 3 * g * ncol) * 4      # rayscale, mu0, alb x2, inc
    return tables + descr + nminor * ncell * 4 + cloud + fields


def work(s, cell=None):
    ncell = s["ncol"] * s["nlay"]
    ops = ncell * (s["ngpt_sw"] * (8 * OPS_MAJOR_CORNER + OPS_RAYLEIGH
                                   + OPS_SW_COMBINE + OPS_SW_LAYER)
                   + covered(s, "sw") * OPS_MINOR)
    return inputs_bytes(s) + 3 * (s["nlay"] + 1) * s["ncol"] * 4, ops
