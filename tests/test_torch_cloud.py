"""Cloud optics: the port's cloud_props twin against the JAX package.

Inputs are drawn with numpy from a seed (water paths with zeros mixed
in, particle sizes anywhere in the tables' range) and given to both
packages, which hold the same tables (convert.py).

  * float32 against the Pallas kernel ``cloud_props_lane`` in interpret
    mode. Both compute lo + f * (hi - lo), times the water path, the
    products and the two-phase sum in the same order, so they agree to
    a few float32 ulps: rtol 1e-6 of each field's largest value.
  * float64 against the JAX XLA table interpolation: rtol 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rte_rrtmgp_tpu.config import set_use_pallas  # noqa: E402
from rte_rrtmgp_tpu.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics as jax_cloud)
from rte_rrtmgp_tpu_torch.config import checks_disabled  # noqa: E402
from rte_rrtmgp_tpu_torch.convert import cloud_optics_from_jax  # noqa: E402
from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (  # noqa: E402
    cloud_props, cloud_props_plain)

NCOL, NLAY, NBND = 8, 8, 4


def _fields(cld, seed=3):
    rng = np.random.default_rng(seed)
    shape = (NCOL, NLAY)
    lwp = np.where(rng.uniform(size=shape) < 0.4, 0.0,
                   rng.uniform(0.5, 80.0, shape))
    iwp = np.where(rng.uniform(size=shape) < 0.4, 0.0,
                   rng.uniform(0.5, 80.0, shape))
    rel = rng.uniform(cld.radliq_lwr, cld.radliq_upr, shape)
    dei = rng.uniform(cld.diamice_lwr, cld.diamice_upr, shape)
    return lwp, iwp, rel, dei


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cloud_optics_lanes_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcld = jax_cloud(nbnd=NBND, dtype=jdt)
    cld = cloud_optics_from_jax(jcld, dtype=tdt, device="cpu")
    fields = _fields(cld)
    got = cld.cloud_optics_lanes(*(torch.as_tensor(f, dtype=tdt)
                                   for f in fields))
    jf = [jnp.asarray(f, jdt) for f in fields]
    if dtype == "float32":
        set_use_pallas(True)
        try:
            ref = jcld.cloud_optics_lanes(*jf, interpret=True)
        finally:
            set_use_pallas(None)
        assert ref is not None, "the JAX cloud LUT kernel did not run"
        rtol = 1e-6
    else:
        ref = tuple(jnp.transpose(x, (2, 1, 0))
                    for x in jcld._triplet_xla(*jf))
        rtol = 1e-12
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == tdt
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=rtol * np.abs(r).max())


def test_cloud_props_dispatch_on_cpu():
    """A CPU tensor goes to the twin; the launch counter does not move."""
    cld = cloud_optics_from_jax(jax_cloud(nbnd=NBND, dtype=jnp.float32),
                                device="cpu")
    args = cld.lane_inputs(*(torch.as_tensor(f, dtype=torch.float32)
                             for f in _fields(cld)))
    before = cloud_props.launches
    out = cloud_props(*args, *cld.tables())
    assert cloud_props.launches == before
    torch.testing.assert_close(out, cloud_props_plain(*args, *cld.tables()),
                               rtol=0, atol=0)
    assert out.shape == (3, NBND, NLAY, NCOL)


def test_cloud_range_checks():
    cld = cloud_optics_from_jax(jax_cloud(nbnd=NBND, dtype=jnp.float64),
                                dtype=torch.float64, device="cpu")
    lwp, iwp, rel, dei = (torch.as_tensor(f) for f in _fields(cld))
    bad = rel.clone()
    bad[lwp > 0] = cld.radliq_upr + 1.0
    with pytest.raises(ValueError, match="liquid effective radius"):
        cld.cloud_optics_lanes(lwp, iwp, bad, dei)
    bad = dei.clone()
    bad[iwp > 0] = cld.diamice_lwr - 1.0
    with pytest.raises(ValueError, match="ice effective diameter"):
        cld.cloud_optics_lanes(lwp, iwp, rel, bad)
    # sizes outside the table where there is no water are not checked
    rel_free = torch.where(lwp > 0, rel, torch.zeros_like(rel))
    cld.cloud_optics_lanes(lwp, iwp, rel_free, dei)
    # with the checks off an out-of-table size extrapolates silently
    bad = rel.clone()
    bad[lwp > 0] = cld.radliq_upr + 1.0
    with checks_disabled():
        tau, _, _ = cld.cloud_optics_lanes(lwp, iwp, bad, dei)
    assert bool(torch.isfinite(tau).all())
