"""The CUDA kernels against their plain twins on the card (marker ``cuda``).

These tests need a CUDA device and skip without one. They import no JAX,
so they run on a GPU host that has none, without the JAX-side conftest:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small shapes, including a g-point count that is not a multiple of the
32-thread warp (the kernels' idle lanes). Kernel and twin get the same
float32 inputs and differ in summation order and fused multiply-adds
only: cloud optics within 1e-6 of the largest value, fluxes within 2e-6
of the largest flux (measured at the main path's shapes: 5e-8 and 2e-7).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch.drivers.allsky import (  # noqa: E402
    allsky_lw_inputs, allsky_sw_inputs, build_allsky, build_allsky_step)
from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (  # noqa: E402
    cloud_props, cloud_props_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (  # noqa: E402
    lw_fused, lw_fused_plain)
from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (  # noqa: E402
    sw_fused, sw_fused_plain)

pytestmark = pytest.mark.cuda

DIMS = {"g32": (10, 9, 32, 4, 32, 4, 5, 10),
        "g24": (7, 12, 24, 3, 40, 5, 6, 11)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, ref, tol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert float((g - r).abs().max()) <= tol * float(r.abs().max())


@pytest.mark.parametrize("dims", sorted(DIMS))
def test_kernels_match_twins(cuda, dims):
    p = build_allsky(*DIMS[dims], device=cuda)
    inp = p.inputs
    args = p.cld_lw.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei) \
        + p.cld_lw.tables()
    n0 = cloud_props.launches
    _close(cloud_props(*args), cloud_props_plain(*args), 1e-6)
    assert cloud_props.launches == n0 + 1
    x = allsky_lw_inputs(inp, p.gas_lw, cloud_optics=p.cld_lw)
    n0 = lw_fused.launches
    _close(lw_fused(x), lw_fused_plain(x), 2e-6)
    assert lw_fused.launches == n0 + 1
    x = allsky_sw_inputs(inp, p.gas_sw, cloud_optics=p.cld_sw)
    n0 = sw_fused.launches
    _close(sw_fused(x), sw_fused_plain(x), 2e-6)
    assert sw_fused.launches == n0 + 1
    torch.cuda.synchronize()


def test_sw_kernel_low_sun_and_night(cuda):
    """Per-column mu0 from night (0) through below the min_mu0 clamp
    (sqrt(eps) = 3.5e-4) to overhead: the kernel's clamps and night
    masking agree with the twin, and a night column has no flux."""
    p = build_allsky(*DIMS["g32"], device=cuda)
    x = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
    nlay, ncol = x.mu0.shape
    mu = torch.tensor([0.0, 1e-4, 3e-4, 1e-3, 0.05, 0.3, 0.6, 0.86, 0.99,
                       1.0], device=cuda)[:ncol]
    x = x._replace(mu0=mu[None, :].expand(nlay, ncol).contiguous())
    got = sw_fused(x)
    _close(got, sw_fused_plain(x), 2e-6)
    assert all(bool((f[:, 0] == 0).all()) for f in got)


def test_step_runs_on_kernels(cuda):
    step, inputs = build_allsky_step(*DIMS["g32"], device=cuda)
    counters = (cloud_props, lw_fused, sw_fused)
    before = [f.launches for f in counters]
    out = step(inputs)
    torch.cuda.synchronize()
    assert all(f.launches > b for f, b in zip(counters, before))
    for o in out:
        assert o.is_cuda and bool(torch.isfinite(o).all())


def test_wrappers_refuse_float64(cuda):
    p = build_allsky(*DIMS["g32"], device=cuda, dtype=torch.float64)
    inp = p.inputs
    args = p.cld_lw.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei) \
        + p.cld_lw.tables()
    with pytest.raises(ValueError, match="dtype"):
        cloud_props(*args)
    x = allsky_lw_inputs(inp, p.gas_lw, use_clouds=False)
    with pytest.raises(ValueError, match="dtype"):
        lw_fused(x)
