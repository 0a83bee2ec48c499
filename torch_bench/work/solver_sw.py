"""Row 9, ``csrc/solver_sw.cu`` (``solver_sw_kernel``): one launch per
step of the public-API all-sky step (``rte_sw``, broadband). Bytes: tau,
ssa and g, mu0 by layer, the two albedos and the incident flux by
(column, g-point), three flux fields; operations: 62 per (cell, g-point)
(Meador-Weaver, the direct beam, adding)."""
OPS_SW_LAYER = 62


def work(s, cell=None):
    ncol, nlay, g = s["ncol"], s["nlay"], s["ngpt_sw"]
    ncell = ncol * nlay
    nbytes = (3 * ncell * g + ncell + 3 * ncol * g
              + 3 * (nlay + 1) * ncol) * 4
    return nbytes, ncell * g * OPS_SW_LAYER
