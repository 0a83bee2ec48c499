"""The minor-gas scaling rows of one gas-optics call: the CUDA kernel
``csrc/minor_scale.cu``, its adjoint, and their plain-PyTorch twins.

No TPU kernel corresponds: the JAX package forms these rows in plain JAX,
one window at a time (``rte_rrtmgp_tpu/ops/gas_optics.py:297-309``), as
``ops/gas_optics.py::minor_scaling`` does here. The kernel forms the rows
of every window of both atmospheres, lower first, in one launch, from a
table built once per k-distribution (``GasOpticsRRTMGP.minor_scale_table``,
the device copy of :func:`ops.gas_optics.window_rows`); the rows equal
the twin's (:func:`minor_scale_plain`) on the same tensors bit for bit.

Cells form a 2-D grid S of any size, in either layout ((nlay, ncol) for
the fused kernels, (ncol, nlay) for the public API); ``play``, ``tlay``,
``tropo`` and ``col_gas`` may be strided views (``play.T``,
``col_gas.transpose(1, 2)``), which the kernel reads through their
strides. The rows come out contiguous, (nwin, *S).

A CUDA tensor goes to the kernel (float32 or float64; anything else
raises), a CPU tensor to the twin. :func:`minor_scale` is differentiable
in play, tlay and col_gas: its backward is one launch of the adjoint
kernel on CUDA (:func:`minor_scale_bwd`, whose closed form is
:func:`minor_scale_bwd_plain`) and the twin's autograd on the CPU.
"""
from __future__ import annotations

import torch

from ..gas_optics import scaling_rows
from ._build import check_args, check_strided, launch, on_cpu, strided
from .autodiff import refuse_grad, with_adjoint

__all__ = ["minor_scale", "minor_scale_plain", "minor_scale_bwd",
           "minor_scale_bwd_plain"]

_DTYPES = (torch.float32, torch.float64)


def minor_scale_plain(tropo, play, tlay, col_gas, idx_h2o: int, windows,
                      table=None):
    """The scaling rows (len(windows), *S) of ``windows`` (rows of
    ``ops.gas_optics.window_rows``, lower atmosphere's first) with their
    atmosphere masks applied; ``table`` (the kernel's copy of
    ``windows``) is not read here."""
    return scaling_rows(tropo, play, tlay, col_gas, idx_h2o, windows)


def minor_scale_bwd_plain(tropo, play, tlay, col_gas, idx_h2o: int,
                          windows, table, g):
    """Cotangents (col_gas, play, tlay) of :func:`minor_scale_plain` for
    the cotangent ``g`` (len(windows), *S) of its rows, in closed form:
    the adjoint kernel's arithmetic, one window at a time."""
    dtype = play.dtype
    c0, ch = col_gas[0], col_gas[idx_h2o]
    inv = 1.0 / c0
    dry = 1.0 / (1.0 + ch * inv)
    r = 0.01 * play / tlay
    masks = {1: tropo.to(dtype), 0: (~tropo).to(dtype)}
    dcol = torch.zeros(col_gas.shape, dtype=dtype, device=play.device)
    dry_bar = dr = torch.zeros_like(r)
    for w, (lower, idx, density, isc, complement) in enumerate(windows):
        gm = g[w] * masks[lower]
        if not density:
            dcol[idx] += gm
            continue
        ci = col_gas[idx]
        if isc <= 0:
            dcol[idx] += gm * r
            dr = dr + gm * ci
            continue
        cs = col_gas[isc]
        frac = cs * inv * dry
        ds1 = gm * ((1.0 - frac) if complement else frac)
        dfrac = (-1.0 if complement else 1.0) * (gm * (ci * r))
        dcol[idx] += ds1 * r
        dr = dr + ds1 * ci
        dcol[isc] += (dfrac * dry) * inv
        dry_bar = dry_bar + dfrac * (cs * inv)
    # the cotangent of 1 / col_dry, formed times 1 / col_dry (alone it
    # passes float32's range)
    dd = -(dry_bar * dry) * dry
    dcol[idx_h2o] += dd * inv
    dcol[0] -= (dry_bar * dry + dd * (ch * inv)) * inv
    return dcol, 0.01 * (dr / tlay), -(dr * r) / tlay


def _check(what, tropo, play, tlay, col_gas, idx_h2o, table):
    """The kernels' shape, dtype and stride checks; returns the dtype's
    flag for the launcher."""
    cells = tuple(play.shape)
    if len(cells) != 2:
        raise ValueError(f"{what}: the kernel takes a 2-D grid of cells, "
                         f"got {cells}")
    if play.dtype not in _DTYPES:
        raise ValueError(f"{what}: play has dtype {play.dtype}; the CUDA "
                         "kernel takes float32 or float64")
    ngas1 = col_gas.shape[0]
    if not 0 <= idx_h2o < ngas1:
        raise ValueError(f"{what}: h2o row {idx_h2o} is not in col_gas")
    dt, i32 = play.dtype, torch.int32
    check_strided(what, play.device, {
        "tropo": (tropo, cells, torch.bool), "play": (play, cells, dt),
        "tlay": (tlay, cells, dt),
        "col_gas": (col_gas, (ngas1,) + cells, dt)})
    check_args(what, play.device,
               {"table": (table, (table.shape[0], 5), i32)})
    return int(dt == torch.float64)


def _minor_scale_kernel(tropo, play, tlay, col_gas, idx_h2o: int, windows,
                        table):
    """:func:`minor_scale_plain` semantics; on CUDA, one launch of the
    hand-written kernel (counted in ``minor_scale.launches``) writing the
    rows of every window of ``table``, the device copy of ``windows``
    ((nwin, 5) int32)."""
    if on_cpu(play, "minor_scale"):
        return minor_scale_plain(tropo, play, tlay, col_gas, idx_h2o,
                                 windows)
    refuse_grad("minor_scale", play, tlay, col_gas,
                hint="minor_scale differentiates it through its adjoint")
    f64 = _check("minor_scale", tropo, play, tlay, col_gas, idx_h2o, table)
    nwin = table.shape[0]
    out = torch.empty((nwin,) + tuple(play.shape), dtype=play.dtype,
                      device=play.device)
    launch("minor_scale", "launch_minor_scale", "minor_scale",
           *strided(tropo, 2), *strided(play, 2), *strided(tlay, 2),
           *strided(col_gas, 3), table, nwin, int(idx_h2o), *play.shape,
           f64, out)
    minor_scale.launches += 1
    return out


def minor_scale_bwd(tropo, play, tlay, col_gas, idx_h2o: int, windows,
                    table, g):
    """:func:`minor_scale_bwd_plain` semantics; on CUDA, one launch of the
    hand-written adjoint kernel (counted in ``minor_scale_bwd.launches``).
    The col_gas cotangent has col_gas's strides (a permuted view gets a
    permuted cotangent), those of play and tlay theirs."""
    if on_cpu(play, "minor_scale_bwd"):
        return minor_scale_bwd_plain(tropo, play, tlay, col_gas, idx_h2o,
                                     windows, table, g)
    refuse_grad("minor_scale_bwd", play, tlay, col_gas, g,
                hint="the adjoints have no backward of their own")
    f64 = _check("minor_scale_bwd", tropo, play, tlay, col_gas, idx_h2o,
                 table)
    nwin = table.shape[0]
    g = g.contiguous()
    check_args("minor_scale_bwd", play.device,
               {"g": (g, (nwin,) + tuple(play.shape), play.dtype)})
    dcol, dplay, dtlay = (torch.empty_like(t) for t in (col_gas, play, tlay))
    launch("minor_scale", "launch_minor_scale_bwd", "minor_scale_bwd",
           *strided(tropo, 2), *strided(play, 2), *strided(tlay, 2),
           *strided(col_gas, 3), table, nwin, int(idx_h2o),
           col_gas.shape[0], *play.shape, f64, g, *strided(dcol, 3),
           *strided(dplay, 2), *strided(dtlay, 2))
    minor_scale_bwd.launches += 1
    return dcol, dplay, dtlay


minor_scale_bwd.launches = 0


def minor_scale(tropo, play, tlay, col_gas, idx_h2o: int, windows, table):
    """The scaling rows (nwin, *S) of every minor window of one gas-optics
    call, lower atmosphere's first: ``windows`` the host rows of
    ``ops.gas_optics.window_rows``, ``table`` their (nwin, 5) int32 copy
    on the device; tropo (*S) bool, play and tlay (*S), col_gas (ngas+1,
    *S), h2o at row ``idx_h2o``. On CUDA one launch of the kernel
    (counted in ``minor_scale.launches``); differentiable in play, tlay
    and col_gas, the backward one launch of the adjoint kernel on CUDA
    and the twin's autograd on the CPU. No windows: an empty (0, *S)
    tensor, nothing launched."""
    if not windows:
        return play.new_zeros((0,) + tuple(play.shape))
    # the host rows and the h2o row ride in the closures, not among the
    # node's arguments, which autograd's wrapper walks on every call
    h2o = int(idx_h2o)

    def adjoint(a, g):
        dcol, dplay, dtlay = minor_scale_bwd(*a[:4], h2o, windows, a[4], g)
        return None, dplay, dtlay, dcol, None

    return with_adjoint(
        lambda tr, p, t, c, tab: _minor_scale_kernel(tr, p, t, c, h2o,
                                                     windows, tab),
        lambda tr, p, t, c, tab: minor_scale_plain(tr, p, t, c, h2o,
                                                   windows),
        adjoint, tropo, play, tlay, col_gas, table, name="minor_scale")


minor_scale.launches = 0
