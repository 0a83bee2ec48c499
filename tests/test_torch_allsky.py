"""The port's all-sky step as a whole against the committed goldens.

``build_allsky_step`` in float64 on the CPU runs the plain twins of all
three kernels (cloud optics, fused LW, fused SW) behind the same entry
points the GPU run uses. Its fluxes must sit within the reference's DP
gate (7e-4 W/m2, tests/test_golden_regression.py:22) of:

  * tests/golden/allsky.npz (12 x 24; 32 g-points in 4 bands, ntemp 6,
    npres 12): the lw_up/lw_dn/sw_up/sw_dn fields. Its aerosol fields
    belong to a later slice of the port;
  * tests/golden/production.npz (256 x 72 at the full spectral widths:
    256/16 LW, 224/14 SW, ntemp 14, npres 59): every field.

The goldens are the JAX package's float64 XLA path; this file imports no
JAX.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch.drivers.allsky import build_allsky_step  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
DP_THRESHOLD = 7.0e-4
FIELDS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir")
CASES = {
    "allsky": ((12, 24, 32, 4, 32, 4, 6, 12),
               ("lw_up", "lw_dn", "sw_up", "sw_dn")),
    "production": ((256, 72, 256, 16, 224, 14, 14, 59), FIELDS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_golden(case):
    dims, keys = CASES[case]
    golden = np.load(os.path.join(GOLDEN_DIR, f"{case}.npz"))
    step, inputs = build_allsky_step(*dims, device="cpu", dtype=torch.float64)
    out = dict(zip(FIELDS, step(inputs)))
    for k in keys:
        got = out[k].numpy()
        assert got.shape == golden[k].shape, k
        d = float(np.abs(got - golden[k]).max())
        assert d <= DP_THRESHOLD, f"{case}/{k}: {d:.3e} W/m2 from the golden"


def test_step_float32_is_physical():
    """The float32 step: finite, non-negative fluxes of the JAX shapes,
    and TOA SW down equal to the incident solar flux times mu0."""
    step, inputs = build_allsky_step(6, 10, 32, 4, 32, 4, 5, 10,
                                     device="cpu")
    out = step(inputs)
    for o in out:
        assert o.shape == (6, 11) and o.dtype == torch.float32
        assert bool(torch.isfinite(o).all()) and bool((o >= 0).all())
    lw_up, lw_dn, sw_up, sw_dn, sw_dir = out
    assert bool((lw_dn[:, 0] == 0).all())
    torch.testing.assert_close(sw_dn[:, 0], sw_dir[:, 0])
    assert bool((sw_dir <= sw_dn * (1 + 1e-6)).all())
