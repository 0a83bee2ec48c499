"""Row 5, ``csrc/gas_minor.cu`` (``gas_minor_kernel``): four launches per
step of the public-API all-sky step, out of place: the LW and the SW
gas optics' lower and upper minor gases. Per launch, bytes: the
temperature index and fraction, the eta indices and fractions, the
atmosphere's minor table and scaling rows, tau read and the new tau
written; operations: 16 per (cell, g-point) a minor window covers."""
OPS_MINOR = 16


def work(s, cell=None):
    ncell = s["ncol"] * s["nlay"]
    nbytes = ops = 0
    for side in ("lw", "sw"):
        g = s[f"ngpt_{side}"]
        for atm in ("lower", "upper"):
            widths = s[f"minor_widths_{side}_{atm}"]
            nbytes += (2 * ncell + 2 * 2 * s[f"nflav_{side}"] * ncell
                       + s["ntemp"] * s["neta"] * sum(widths)
                       + len(widths) * ncell + 2 * ncell * g) * 4
            ops += ncell * sum(widths) * OPS_MINOR
    return nbytes, ops
