"""The cloud optics' range check (``CloudOpticsRRTMGP.validate_inputs``)
on the CPU, counted through ``trace.collect()``.

One host read per check (the wait site ``cloud.ranges``), the liquid
radius error before the ice diameter error; a check right after a
passed check on the very same tensors, unchanged and against the same
bounds, returns without a read (the counter ``check.cloud.reused``) and
spends the record, so a third call reads again. Anything else reads
again: another tensor with the same values or at the same address, an
in-place write (directly or through a view of the base), other bounds, a
check that raised before, numpy arguments; and a buffer refilled behind
the version counter is read on the next step. The record holds no
tensor alive.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rte_rrtmgp_tpu_torch import trace  # noqa: E402
from rte_rrtmgp_tpu_torch.models.rrtmgp import cloud_optics  # noqa: E402
from rte_rrtmgp_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_cloud_optics)

NCOL, NLAY = 6, 5


def _fields(cld):
    """(lwp, iwp, rel, dei): water in about half the cells, sizes inside
    the tables' ranges."""
    rng = np.random.default_rng(7)
    shape = (NCOL, NLAY)
    wp = lambda: np.where(rng.uniform(size=shape) < 0.5, 0.0,
                          rng.uniform(1.0, 20.0, shape))
    rel = rng.uniform(cld.radliq_lwr, cld.radliq_upr, shape)
    dei = rng.uniform(cld.diamice_lwr, cld.diamice_upr, shape)
    return [torch.as_tensor(a, dtype=torch.float32)
            for a in (wp(), wp(), rel, dei)]


def _check(cld, f, match=None):
    if match is None:
        cld.validate_inputs(*f)
    else:
        with pytest.raises(ValueError, match=match):
            cld.validate_inputs(*f)


def _liquid_out_of_range(cld, f):
    f[2] = torch.where(f[0] > 0, cld.radliq_upr + 1.0, f[2])
    _check(cld, f, "liquid effective radius")
    return 1, 0


def _ice_out_of_range(cld, f):
    f[3] = torch.where(f[1] > 0, cld.diamice_lwr - 1.0, f[3])
    _check(cld, f, "ice effective diameter")
    return 1, 0


def _both_out_of_range(cld, f):
    f[2] = torch.where(f[0] > 0, cld.radliq_lwr - 1.0, f[2])
    f[3] = torch.where(f[1] > 0, cld.diamice_upr + 1.0, f[3])
    _check(cld, f, "liquid effective radius")
    return 1, 0


def _same_tensors_twice(cld, f):
    _check(cld, f)
    _check(cld, f)
    return 1, 1


def _record_is_one_shot(cld, f):
    """Two steps of an LW and an SW check on the same tensors: the SW
    call reuses, the next LW call reads again."""
    for _ in range(2):
        _check(cld, f)
        _check(cld, f)
    return 2, 2


def _refill_behind_the_counter_next_step(cld, f):
    """Buffers wrapped once from numpy and refilled there in place, which
    PyTorch's version counter does not see: the next step's first check
    reads the new values and raises."""
    arrays = [a.numpy().copy() for a in f]
    f = [torch.from_numpy(a) for a in arrays]
    _check(cld, f)
    _check(cld, f)
    version = f[2]._version
    arrays[2][arrays[0] > 0] = cld.radliq_upr + 1.0
    assert f[2]._version == version
    _check(cld, f, "liquid effective radius")
    return 2, 1


def _lw_then_sw_object(cld, f):
    """The fused LW call's lanes, then the public SW call on another
    object with the same bounds: one read."""
    sw = dataclasses.replace(cld)
    cld.cloud_optics_lanes(*f)
    sw.cloud_optics(*f)
    return 1, 1


def _in_place_mul(cld, f):
    _check(cld, f)
    f[2].mul_(100.0)
    _check(cld, f, "liquid effective radius")
    return 2, 0


def _write_through_view_of_base(cld, f):
    base = torch.stack([f[2], f[2]])
    f[2] = base[1]
    _check(cld, f)
    base.view(-1)[NCOL * NLAY:].fill_(cld.radliq_upr + 1.0)
    _check(cld, f, "liquid effective radius")
    return 2, 0


def _new_tensor_same_values(cld, f):
    _check(cld, f)
    f[2] = f[2].clone()
    _check(cld, f)
    return 2, 0


def _freed_address_reused(cld, f):
    """A new tensor object on the freed one's storage: the same address
    and the same version counter, and read again all the same."""
    base = torch.stack([f[2], f[2]])
    f[2] = base[0]
    _check(cld, f)
    ptr, version = f[2].data_ptr(), f[2]._version
    f[2] = None
    gc.collect()
    f[2] = base[0]
    assert (f[2].data_ptr(), f[2]._version) == (ptr, version)
    _check(cld, f)
    return 2, 0


def _narrower_bounds(cld, f):
    _check(cld, f)
    lo = float(f[2][f[0] > 0].max()) + 0.1
    narrow = dataclasses.replace(cld, radliq_lwr=lo)
    _check(narrow, f, "liquid effective radius")
    return 2, 0


def _raised_leaves_no_record(cld, f):
    _check(cld, f)
    bad = list(f)
    bad[3] = torch.where(f[1] > 0, cld.diamice_upr + 1.0, f[3])
    _check(cld, bad, "ice effective diameter")
    assert cloud_optics._checked is None
    _check(cld, bad, "ice effective diameter")
    _check(cld, f)
    return 4, 0


def _numpy_every_time(cld, f):
    f = [a.numpy() for a in f]
    _check(cld, f)
    _check(cld, f)
    f[2] = np.where(f[0] > 0, cld.radliq_upr + 1.0, f[2])
    _check(cld, f, "liquid effective radius")
    return 3, 0


def _holds_no_tensor(cld, f):
    _check(cld, f)
    refs = cloud_optics._checked[0]
    assert len(refs) == 4 and all(r() is a for r, a in zip(refs, f))
    f.clear()
    gc.collect()
    assert all(r() is None for r in refs)
    return 1, 0


CASES = {fn.__name__.lstrip("_"): fn for fn in (
    _liquid_out_of_range, _ice_out_of_range, _both_out_of_range,
    _same_tensors_twice, _record_is_one_shot,
    _refill_behind_the_counter_next_step, _lw_then_sw_object, _in_place_mul,
    _write_through_view_of_base, _new_tensor_same_values,
    _freed_address_reused, _narrower_bounds, _raised_leaves_no_record,
    _numpy_every_time, _holds_no_tensor)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cloud_check_reads_once_and_reuses_only_what_it_saw(case,
                                                            monkeypatch):
    cld = synthetic_cloud_optics(4, device="cpu")
    monkeypatch.setattr(cloud_optics, "_checked", None)
    f = _fields(cld)
    with trace.collect() as rec:
        waits, reused = CASES[case](cld, f)
    assert rec.counters["waits"] == waits
    assert rec.counters.get("check.cloud.reused", 0) == reused
    sites = [r[0] for r in rec.spans if r[0].startswith("wait.")]
    assert sites == ["wait.cloud.ranges"] * waits
