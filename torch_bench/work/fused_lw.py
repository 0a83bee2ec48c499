"""Row 2, ``csrc/fused_lw.cu`` (``fused_lw_kernel``): one launch per step
of the fused all-sky and RFMIP forward steps. Operations per cell and
g-point, counted from the kernel's arithmetic (an exp or a division
counts as one): 8 corners of the major lookup (weight, x col_mix,
multiply-add: 5) with the Planck fraction's (2), the totplnk lerps and
level mean (12), the source and both sweeps (24); 16 per (cell, g-point)
a minor window covers. Bytes: each input read once, each output written
once: the interleaved (kmajor, Planck fraction) table, the minor tables,
totplnk, the descriptors, the minor scaling rows, the temperatures, the
boundary fields, the clouds' absorption by band, two flux fields."""
OPS_MAJOR_CORNER = 5
OPS_PFRAC_CORNER = 2
OPS_MINOR = 16
OPS_PLANCK = 12
OPS_LW_LAYER = 24


def covered(s, side):
    return (sum(s[f"minor_widths_{side}_lower"])
            + sum(s[f"minor_widths_{side}_upper"]))


def inputs_bytes(s, tables_bytes):
    """The fused LW inputs but its major table(s)."""
    ncol, nlay, g = s["ncol"], s["nlay"], s["ngpt_lw"]
    ncell, nlev = ncol * nlay, nlay + 1
    nminor = (len(s["minor_widths_lw_lower"])
              + len(s["minor_widths_lw_upper"]))
    kminor = s["ntemp"] * s["neta"] * covered(s, "lw") * 4
    descr = 5 * ncell * 4 + 3 * 2 * s["nflav_lw"] * ncell * 4
    fields = (ncell + nlev * ncol + ncol + 2 * g * ncol) * 4
    cloud = s["nbnd_lw"] * ncell * 4 if s["clouds"] else 0
    return (tables_bytes + kminor + s["nplanck"] * s["nbnd_lw"] * 4 + descr
            + nminor * ncell * 4 + fields + cloud)


def work(s, cell=None):
    ncell = s["ncol"] * s["nlay"]
    g = s["ngpt_lw"]
    ops = ncell * (g * (8 * (OPS_MAJOR_CORNER + OPS_PFRAC_CORNER)
                        + OPS_PLANCK + OPS_LW_LAYER)
                   + covered(s, "lw") * OPS_MINOR)
    table = s["ntemp"] * s["neta"] * (s["npres"] + 1) * g * 2 * 4
    out = 2 * (s["nlay"] + 1) * s["ncol"] * 4
    return inputs_bytes(s, table) + out, ops
