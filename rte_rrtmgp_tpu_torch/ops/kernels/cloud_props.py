"""Cloud particle-size LUT: the CUDA kernel ``csrc/cloud_props.cu`` and
its plain-PyTorch twin.

Replaces the TPU kernel ``rte_rrtmgp_tpu/ops/pallas/minor_gather.py::
cloud_props_lane`` (reference ``compute_cld_from_table``,
rrtmgp/kernels/mo_cloud_optics_rrtmgp_kernels.F90:24-65): for each cell,
band and phase (liquid, ice), lerp (ext, ssa, asy) between size bins
``idx`` and ``idx+1`` by ``fint``, scale by the masked water path, and
sum (tau, tau*ssa, tau*ssa*g) over the phases.

A CUDA tensor goes to the kernel (float32 only; anything else raises), a
CPU tensor to :func:`cloud_props_plain`.
"""
from __future__ import annotations

import torch

from ._build import check_args, launch, on_cpu

__all__ = ["cloud_props", "cloud_props_plain"]


def cloud_props_plain(idx, fint, wp, liq, ice):
    """idx (2, nlay, ncol) int32 lower size bin per phase; fint, wp
    (2, nlay, ncol); liq/ice (3, nsize, nbnd) = (ext, ssa, asy) tables.
    Returns (3, nbnd, nlay, ncol) = (tau, tau*ssa, tau*ssa*g) by band."""
    out = None
    for phase, tab in enumerate((liq, ice)):
        i = idx[phase].long()
        f = fint[phase][None, ..., None]                # (1, nlay, ncol, 1)
        lo = tab[:, i]                                  # (3, nlay, ncol, nbnd)
        hi = tab[:, i + 1]
        v = lo + f * (hi - lo)
        t = wp[phase][..., None] * v[0]
        ts = t * v[1]
        tsg = ts * v[2]
        term = torch.stack([t, ts, tsg]).permute(0, 3, 1, 2)
        out = term if out is None else out + term
    return out.contiguous()


def cloud_props(idx, fint, wp, liq, ice):
    """:func:`cloud_props_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``cloud_props.launches``)."""
    if on_cpu(wp, "cloud_props"):
        return cloud_props_plain(idx, fint, wp, liq, ice)
    _, nlay, ncol = wp.shape
    nsl, nbnd = liq.shape[1], liq.shape[2]
    nsi = ice.shape[1]
    f32, i32 = torch.float32, torch.int32
    check_args("cloud_props", wp.device, {
        "idx": (idx, (2, nlay, ncol), i32),
        "fint": (fint, (2, nlay, ncol), f32),
        "wp": (wp, (2, nlay, ncol), f32),
        "liq": (liq, (3, nsl, nbnd), f32),
        "ice": (ice, (3, nsi, nbnd), f32)})
    out = torch.empty((3, nbnd, nlay, ncol), dtype=f32, device=wp.device)
    launch("cloud_props", "launch_cloud_props", "cloud_props",
           idx, fint, wp, liq, ice, out, nlay * ncol, nbnd, nsl, nsi)
    cloud_props.launches += 1
    return out


cloud_props.launches = 0
