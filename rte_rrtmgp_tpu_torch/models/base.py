"""What every gas-optics provider shares.

Counterpart of ``rte_rrtmgp_tpu.models.base`` (reference ``ty_gas_optics``,
rte/frontend/gas-optics-template/mo_gas_optics.F90:41-126).
"""
from __future__ import annotations

from .. import trace

__all__ = ["infer_top_at_1"]


def infer_top_at_1(play, top_at_1=None) -> bool:
    """The vertical orientation: ``top_at_1`` when given, else inferred
    from the pressures (reference mo_gas_optics_rrtmgp.F90:258): the top
    of the atmosphere is at layer index 0 iff pressure increases with the
    index. Inferring reads two values of ``play`` back from its device."""
    if top_at_1 is not None:
        return bool(top_at_1)
    with trace.wait("top_at_1"):
        return bool(play[0, 0] < play[0, -1])
