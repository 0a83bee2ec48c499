"""``csrc/aerosol_props.cu`` (``aerosol_props_kernel``) in the whole-grid
stream with aerosols (``parallel/scaling.AllSkyStream``), per sweep: one
launch per gas-optics call, the LW calls on every column (the
absorption, the clouds' folded in) and the SW calls on the day columns
(the delta-scaled aerosols combined with the clouds'), from the cell's
shapes, float32. Each chunk of ``chunk`` columns makes one LW launch and,
under a sun uniform in mu0 on the cell's range, one SW launch.

Bytes: per cell its 16 B of input (type, size, mass, relative humidity),
the clouds' lanes it reads (LW: tau and tau*ssa by band; SW: all three)
and the lanes it writes (LW: one by band; SW: three); per launch the row
table, the RH grid and the bin limits once. Operations (an exp or a
division counts as one): per cell the bin search (2 per bin), the RH
search (1 per grid point) and the RH weight (3); per (cell, band) the
three RH lerps (9) and the triplet (3), then LW the two absorptions and
their sum (3), SW the delta scaling of both (2 x 11) and the combine
(13)."""
OPS_CELL = 3
OPS_BAND = 12
OPS_LW = 3
OPS_SW = 2 * 11 + 13


def day_share(cell) -> float:
    """The expected share of day columns under the cell's sun: mu0
    uniform on [lo, hi], day where mu0 > 0."""
    lo, hi = cell["traffic"]["mu0"]
    return (hi - max(lo, 0.0)) / (hi - lo)


def launch_work(s, ncol: int, nbnd: int, sw: bool):
    """(bytes, operations) of one launch on ``ncol`` columns."""
    nbin, nrh = s["aerosol_nbin"], s["aerosol_nrh"]
    ncell = ncol * s["nlay"]
    lanes = 3 if sw else 2
    rows = 1 + nbin + nrh * nbin + 3 * nrh + 2
    per_cell = 16 + 4 * nbnd * (lanes + (3 if sw else 1))
    once = 4 * (rows * 3 * nbnd + nrh + 2 * nbin)
    ops = ncell * (2 * nbin + nrh + OPS_CELL
                   + nbnd * (OPS_BAND + (OPS_SW if sw else OPS_LW)))
    return ncell * per_cell + once, ops


def work(s, cell):
    nchunk = -(-s["ncol"] // s["chunk"])
    lw = launch_work(s, s["ncol"], s["nbnd_lw"], False)
    sw = launch_work(s, round(day_share(cell) * s["ncol"]), s["nbnd_sw"],
                     True)
    once_sw = launch_work(s, 0, s["nbnd_sw"], True)[0]
    once_lw = launch_work(s, 0, s["nbnd_lw"], False)[0]
    return (lw[0] + sw[0] + (nchunk - 1) * (once_lw + once_sw),
            lw[1] + sw[1])
