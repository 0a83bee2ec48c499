"""The port's optical-property algebra (optical_props.py).

The cases of tests/test_optical_props.py and the increment/delta-scale
regressions of tests/test_r5_regressions.py, one for one, on the port's
containers; then every increment pairing (1scl/2str/nstr into
1scl/2str/nstr, on the same g-point grid and by band) and delta_scale
held against the JAX package on the same float64 inputs (numpy seed):
both compute the same expressions, bound 1e-12 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import rte_rrtmgp_tpu.optical_props as jop  # noqa: E402
from rte_rrtmgp_tpu.spectral import SpectralGrid as JGrid  # noqa: E402
from rte_rrtmgp_tpu_torch.optical_props import (  # noqa: E402
    OpticalProps1scl, OpticalProps2str, OpticalPropsNstr, delta_scale,
    increment, subset, to_1scl, validate)
from rte_rrtmgp_tpu_torch.spectral import SpectralGrid  # noqa: E402

# two bands, 4 g-points: band 1 -> gpts 1-2, band 2 -> gpts 3-4
GRID = SpectralGrid.from_arrays([[0., 500.], [500., 1000.]], [[1, 2], [3, 4]])
BAND_GRID = SpectralGrid.from_arrays([[0., 500.], [500., 1000.]],
                                     [[1, 1], [2, 2]])
NCOL, NLAY, NMOM = 4, 3, 3
F64 = torch.float64


def arrays(seed, ngpt, kind):
    rng = np.random.default_rng(seed)
    shape = (NCOL, NLAY, ngpt)
    a = dict(tau=rng.uniform(0.1, 5.0, shape))
    if kind != "1scl":
        a["ssa"] = rng.uniform(0.1, 0.9, shape)
    if kind == "2str":
        a["g"] = rng.uniform(-0.5, 0.9, shape)
    if kind == "nstr":
        a["p"] = rng.uniform(-0.3, 0.8, (NMOM,) + shape)
    return a


PORT = {"1scl": OpticalProps1scl, "2str": OpticalProps2str,
        "nstr": OpticalPropsNstr}
JAX = {"1scl": jop.OpticalProps1scl, "2str": jop.OpticalProps2str,
       "nstr": jop.OpticalPropsNstr}


def port_props(a, kind, grid=GRID):
    return PORT[kind](grid=grid, **{k: torch.as_tensor(v, dtype=F64)
                                    for k, v in a.items()})


def jax_props(a, kind, grid):
    jgrid = JGrid(band_lims_wvn=grid.band_lims_wvn,
                  band_lims_gpt=grid.band_lims_gpt)
    return JAX[kind](grid=jgrid, **{k: jnp.asarray(v) for k, v in a.items()})


def make_2str(seed=0, grid=GRID):
    return port_props(arrays(seed, grid.ngpt, "2str"), "2str", grid)


def test_spectral_grid_maps():
    assert GRID.nband == 2 and GRID.ngpt == 4
    np.testing.assert_array_equal(GRID.gpt2band, [0, 0, 1, 1])
    assert GRID.bands_are_equal(BAND_GRID)
    assert not GRID.gpoints_are_equal(BAND_GRID)


def test_increment_transparent_is_identity():
    a = make_2str()
    zero = OpticalProps2str(tau=torch.zeros_like(a.tau),
                            ssa=torch.zeros_like(a.ssa),
                            g=torch.zeros_like(a.g), grid=GRID)
    b = increment(a, zero)
    for f in ("tau", "ssa", "g"):
        torch.testing.assert_close(getattr(b, f), getattr(a, f))


def test_increment_2str_by_2str_weighting():
    a, b = make_2str(0), make_2str(1)
    c = increment(a, b)
    tau12 = a.tau + b.tau
    tauscat = a.tau * a.ssa + b.tau * b.ssa
    torch.testing.assert_close(c.tau, tau12)
    torch.testing.assert_close(c.ssa, tauscat / tau12)
    torch.testing.assert_close(
        c.g, (a.tau * a.ssa * a.g + b.tau * b.ssa * b.g) / tauscat)


def test_increment_by_band_expansion():
    a = make_2str(0)
    b = make_2str(1, grid=BAND_GRID)
    c = increment(a, b)
    band = torch.as_tensor(GRID.gpt2band).long()
    b_exp = OpticalProps2str(tau=b.tau[..., band], ssa=b.ssa[..., band],
                             g=b.g[..., band], grid=GRID)
    c2 = increment(a, b_exp)
    assert torch.equal(c.tau, c2.tau) and torch.equal(c.g, c2.g)


def test_increment_1scl_by_2str_absorption_only():
    a1 = OpticalProps1scl(tau=make_2str(0).tau, grid=GRID)
    b = make_2str(1)
    c = increment(a1, b)
    torch.testing.assert_close(c.tau, a1.tau + b.tau * (1 - b.ssa))


def test_delta_scale_f0_is_identity():
    a = make_2str()
    b = delta_scale(a, f=torch.zeros_like(a.tau))
    for f in ("tau", "ssa", "g"):
        torch.testing.assert_close(getattr(b, f), getattr(a, f))


def test_delta_scale_default_g_squared():
    a = make_2str()
    b = delta_scale(a)
    f = a.g ** 2
    torch.testing.assert_close(b.tau, (1 - a.ssa * f) * a.tau)
    torch.testing.assert_close(b.ssa, a.ssa * (1 - f) / (1 - a.ssa * f))
    torch.testing.assert_close(b.g, (a.g - f) / (1 - f))


def test_delta_scale_conserves_absorption():
    a = make_2str()
    b = delta_scale(a)
    torch.testing.assert_close(b.tau * (1 - b.ssa), a.tau * (1 - a.ssa))


def test_subset_roundtrip():
    a = make_2str()
    s0, s1 = subset(a, 0, 2), subset(a, 2, 2)
    assert torch.equal(torch.cat([s0.tau, s1.tau]), a.tau)
    assert torch.equal(torch.cat([s0.g, s1.g]), a.g)


def test_to_1scl():
    a = make_2str()
    torch.testing.assert_close(to_1scl(a).tau, a.tau * (1 - a.ssa))


@pytest.mark.parametrize("field,value,match", [
    ("tau", -1.0, "tau"), ("tau", float("nan"), "tau"),
    ("ssa", 1.5, "ssa"), ("g", -1.5, "g")])
def test_validate_raises_on_bad_values(field, value, match):
    good = make_2str()
    validate(good)
    bad = getattr(good, field).clone()
    bad[0, 0, 0] = value
    with pytest.raises(ValueError, match=match):
        validate(dataclasses.replace(good, **{field: bad}))


def test_increment_2str_by_nstr_uses_first_moment():
    """2str += nstr takes the first phase moment as the asymmetry (the r5
    fix of increment_2stream_by_nstream)."""
    rng = np.random.default_rng(1)
    shape = (2, 3, 4)
    grid = SpectralGrid.from_arrays(np.array([[10.0, 3000.0]]),
                                    np.array([[1, 4]]))
    t = OpticalProps2str(tau=torch.as_tensor(rng.uniform(0.1, 1, shape)),
                         ssa=torch.full(shape, 0.5, dtype=F64),
                         g=torch.full(shape, 0.3, dtype=F64), grid=grid)
    p = torch.zeros((4,) + shape, dtype=F64)
    p[0] = 0.85
    o_n = OpticalPropsNstr(tau=torch.full(shape, 0.7, dtype=F64),
                           ssa=torch.full(shape, 0.9, dtype=F64), p=p,
                           grid=grid)
    o_2 = OpticalProps2str(tau=o_n.tau, ssa=o_n.ssa,
                           g=torch.full(shape, 0.85, dtype=F64), grid=grid)
    torch.testing.assert_close(increment(t, o_n).g, increment(t, o_2).g)
    assert float(increment(t, o_n).g.max()) > 0.3


def test_increment_nstr_mom_lim():
    """nstr += nstr with fewer moments blends min(nmom) moments and leaves
    the target's higher moments as they are (the r5 fix)."""
    shape = (2, 3, 4)
    grid = SpectralGrid.from_arrays(np.array([[10.0, 3000.0]]),
                                    np.array([[1, 4]]))
    t = OpticalPropsNstr(tau=torch.ones(shape, dtype=F64),
                         ssa=torch.full(shape, 0.5, dtype=F64),
                         p=torch.full((4,) + shape, 0.2, dtype=F64),
                         grid=grid)
    o = OpticalPropsNstr(tau=torch.ones(shape, dtype=F64),
                         ssa=torch.full(shape, 0.5, dtype=F64),
                         p=torch.full((2,) + shape, 0.8, dtype=F64),
                         grid=grid)
    out = increment(t, o)
    assert out.p.shape[0] == 4
    torch.testing.assert_close(out.p[0], torch.full(shape, 0.5, dtype=F64))
    torch.testing.assert_close(out.p[3], torch.full(shape, 0.2, dtype=F64))


def test_delta_scale_f_bounds():
    p = make_2str()
    with pytest.raises(ValueError, match="bounds"):
        delta_scale(p, f=torch.full_like(p.tau, 1.2))


KINDS = ("1scl", "2str", "nstr")


@pytest.mark.parametrize("by_band", [False, True], ids=["gpt", "band"])
@pytest.mark.parametrize("target,other",
                         [(t, o) for t in KINDS for o in KINDS])
def test_increment_matches_jax(target, other, by_band):
    """Every pairing of the reference's increment dispatch, the other
    props on the same g-point grid or by band, against the JAX package."""
    ogrid = BAND_GRID if by_band else GRID
    ta, oa = arrays(3, GRID.ngpt, target), arrays(4, ogrid.ngpt, other)
    got = increment(port_props(ta, target), port_props(oa, other, ogrid))
    ref = jop.increment(jax_props(ta, target, GRID),
                        jax_props(oa, other, ogrid))
    assert type(got).__name__ == type(ref).__name__
    for f in ("tau", "ssa", "g", "p"):
        if hasattr(ref, f):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("with_f", [False, True], ids=["g2", "f"])
def test_delta_scale_matches_jax(with_f):
    a = arrays(5, GRID.ngpt, "2str")
    f = np.random.default_rng(6).uniform(0.0, 0.9, a["tau"].shape)
    got = delta_scale(port_props(a, "2str"),
                      torch.as_tensor(f) if with_f else None)
    ref = jop.delta_scale(jax_props(a, "2str", GRID),
                          jnp.asarray(f) if with_f else None)
    for name in ("tau", "ssa", "g"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12)
