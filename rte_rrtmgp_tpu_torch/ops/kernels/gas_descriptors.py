"""The gas-optics descriptors of one call: the CUDA kernel
``csrc/gas_descriptors.cu``, its adjoint, and their plain-PyTorch twins.

No TPU kernel corresponds: the JAX package forms the column amounts and
the interpolation coefficients in plain JAX (``rte_rrtmgp_tpu/ops/
gas_optics.py``, ``interpolation``), as ``ops/gas_optics.py::
column_amounts`` and ``interpolation`` do here. The kernel forms col_gas
(ngas+1, *S), dry air in row 0, and the :class:`InterpCoeffs` of every
cell in one launch, reading the k-distribution's device tables
(:func:`ops.gas_optics.interp_tables`, made once per k-distribution) and
each gas's vmr where it lies: a device tensor through its strides (a
profile's or a scalar's broadcast axes stride 0) or, for a scalar kept on
the host, its value. Every pointer, stride and value goes into the
launch's parameter struct: the call makes no host-to-device copy and no
host wait. The outputs equal the twin's (:func:`gas_descriptors_plain`)
on the card bit for bit.

Cells are the (ncol, nlay) ones of play, tlay and plev (ncol, nlay+1);
the outputs come out contiguous in the layout asked: (nlay, ncol) cells
for the fused kernels (``layer_major``), (ncol, nlay) for the public API.

A CUDA tensor goes to the kernel (float32 or float64; anything else
raises), a CPU tensor to the twin. :func:`gas_descriptors` is
differentiable in play, tlay, plev, a given col_dry and every vmr tensor:
its backward is one launch of the adjoint kernel on CUDA
(:func:`gas_descriptors_bwd`, whose closed form is
:func:`gas_descriptors_bwd_plain`) and the twin's autograd on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import constants
from ..gas_optics import InterpCoeffs, column_amounts, interpolation
from ._build import check_args, check_strided, launch, on_cpu, strided
from .autodiff import refuse_grad, with_adjoint

__all__ = ["gas_descriptors", "gas_descriptors_plain", "gas_descriptors_bwd",
           "gas_descriptors_bwd_plain", "cell_cotangents", "MAX_GASES"]

MAX_GASES = 64            # csrc/gas_descriptors.cu kMaxGas
_DTYPES = (torch.float32, torch.float64)
_KINDS = {torch.float32: 1, torch.float64: 2}   # 0 absent, 3 host value


def _layout(x, layer_major: bool):
    """A logical (..., ncol, nlay) tensor in the outputs' layout."""
    return x.transpose(-1, -2) if layer_major else x


def gas_descriptors_plain(play, tlay, plev, vmrs, col_dry, idx_h2o: int,
                          tables, layer_major: bool):
    """(col_gas, :class:`InterpCoeffs`), each contiguous in the layout
    asked: :func:`ops.gas_optics.column_amounts` and
    :func:`ops.gas_optics.interpolation` on the (ncol, nlay) cells, or on
    their layer-major views."""
    col_gas = column_amounts(play, plev, vmrs, col_dry, idx_h2o)
    if not layer_major:
        return col_gas, interpolation(play, tlay, col_gas, tables)
    cg = col_gas.transpose(1, 2)
    co = interpolation(play.T, tlay.T, cg, tables)
    return cg.contiguous(), InterpCoeffs(*(t.contiguous() for t in co))


def cell_cotangents(play, tlay, plev, vmrs, col_dry, idx_h2o: int, tables,
                    grads):
    """What the adjoint kernel writes, per (ncol, nlay) cell, for the
    cotangents ``grads`` = (col_gas, ftemp, fpress, col_mix, feta) of
    :func:`gas_descriptors_plain`'s outputs on those cells: (play, tlay,
    the layer's pressure thickness plev[:, k] - plev[:, k+1] (None with a
    given col_dry), col_dry (None without one), one per-cell cotangent per
    vmr (None for an absent gas))."""
    dtype = play.dtype
    g_cg, g_ft, g_fp, g_cm, g_fe = grads
    col_gas = column_amounts(play, plev, vmrs, col_dry, idx_h2o)
    co = interpolation(play, tlay, col_gas, tables)
    cd = col_gas[0]
    ntemp = tables.temp_ref.shape[0]
    tiny2 = 2.0 * torch.finfo(dtype).tiny
    g1, g2 = tables.flavor.tolist()
    c1 = col_gas[tables.flavor[0]]
    dcol = g_cg.clone()
    for it in (0, 1):
        jt = torch.clamp(co.jtemp + it, 0, ntemp - 1).long()
        r = torch.where(co.tropo, tables.vmr_ratio[0][:, jt],
                        tables.vmr_ratio[1][:, jt])
        cm = co.col_mix[it]
        big = cm > tiny2
        safe = torch.where(big, cm, 1.0)
        deta = g_fe[it] * (tables.neta - 1)
        # col_mix = c1 + r c2; feta = (neta - 1) c1 / col_mix where
        # col_mix passes twice the smallest normal, else constant
        d1 = torch.where(big, deta / safe, 0.0)
        dcm = g_cm[it] - torch.where(big, (deta * (c1 / safe)) / safe, 0.0)
        for f in range(len(g1)):
            dcol[g1[f]] += d1[f] + dcm[f]
            dcol[g2[f]] += dcm[f] * r[f]
    # col_gas[k] = vmr_k col_dry
    vm = [None if v is None else v.to(dtype) for v in vmrs]
    dcd = dcol[0].clone()
    for k, v in enumerate(vm):
        if v is not None:
            dcd += dcol[k + 1] * v
    dv = [None if v is None else dcol[k + 1] * cd for k, v in enumerate(vm)]
    if col_dry is not None:
        return g_fp / tables.press_ref_log_delta / play, \
            g_ft / tables.temp_ref_delta, None, dcd, dv
    # col_dry = 10 dp A fact / (1e5 g m_air), m_air = (m_dry + m_h2o v)
    # fact: fact cancels, d col_dry / d v = -col_dry m_h2o / (m_dry +
    # m_h2o v), d col_dry / d dp = 10 A fact / den
    vh = vm[idx_h2o - 1]
    vh = torch.zeros_like(play) if vh is None else vh
    s = constants.m_dry + constants.m_h2o * vh
    if dv[idx_h2o - 1] is not None:
        dv[idx_h2o - 1] = dv[idx_h2o - 1] - (dcd * cd) * constants.m_h2o / s
    fact = 1.0 / (1.0 + vh)
    den = 1000.0 * (s * fact) * 100.0 * constants.grav
    dthick = dcd * ((10.0 * constants.avogad * fact) / den) * torch.sign(
        plev[:, :-1] - plev[:, 1:])
    return (g_fp / tables.press_ref_log_delta / play,
            g_ft / tables.temp_ref_delta, dthick, None, dv)


def _levels(dthick, plev):
    """The levels' cotangent from the layers' thickness cotangents."""
    dplev = torch.zeros_like(plev)
    dplev[:, :-1] += dthick
    dplev[:, 1:] -= dthick
    return dplev


def _sum_to(d, v):
    """A per-cell (ncol, nlay) cotangent summed over the broadcast axes of
    ``v`` (a scalar, profile or field), in ``v``'s dtype."""
    if v.ndim == 0:
        d = d.sum()
    elif v.ndim == 1:
        d = d.sum(0)
    return d.to(v.dtype)


def gas_descriptors_bwd_plain(play, tlay, plev, vmrs, col_dry,
                              idx_h2o: int, tables, layer_major: bool,
                              grads):
    """Cotangents (play, tlay, plev, col_dry, vmrs) of
    :func:`gas_descriptors_plain` for the cotangents ``grads`` = (col_gas,
    ftemp, fpress, col_mix, feta) of its outputs, in closed form: the
    adjoint kernel's arithmetic (:func:`cell_cotangents`), then the
    levels' sums and each vmr's sum over its broadcast axes. plev's is
    None with a given col_dry, col_dry's None without one; each vmr's has
    the vmr's shape and dtype, None for an absent gas."""
    dplay, dtlay, dthick, dcd, dv = cell_cotangents(
        play, tlay, plev, vmrs, col_dry, idx_h2o, tables,
        tuple(_layout(g, layer_major) for g in grads))
    return (dplay, dtlay, None if dthick is None else _levels(dthick, plev),
            dcd, tuple(None if d is None else _sum_to(d, v)
                       for d, v in zip(dv, vmrs)))


def _consts(tables, dtype):
    """The kernel's constants (csrc/gas_descriptors.cu ``Const``), formed
    as the twin forms them on the card: a division by a host scalar is the
    product with its reciprocal, formed in the data's precision."""
    f = np.float32 if dtype == torch.float32 else np.float64
    t = tables
    return (ctypes.c_double * 12)(
        t.temp_ref_min - t.temp_ref_delta,
        float(f(1.0) / f(t.temp_ref_delta)),
        t.press_ref_log0,
        float(f(1.0) / f(t.press_ref_log_delta)),
        t.trop, 2.0 * torch.finfo(dtype).tiny, float(t.neta - 1),
        float(t.npres - 1), constants.m_h2o, constants.m_dry,
        constants.avogad, constants.grav)


def _gases(what, vmrs, play):
    """The launch's gas arrays: pointers, kinds, (column, layer) strides,
    host values and their count."""
    n = len(vmrs)
    if n > MAX_GASES:
        raise ValueError(f"{what}: {n} gases; the kernel takes at most "
                         f"{MAX_GASES}")
    ptrs = (ctypes.c_void_p * n)()
    kinds = (ctypes.c_int * n)()
    strides = (ctypes.c_int * (2 * n))()
    values = (ctypes.c_double * n)()
    for k, v in enumerate(vmrs):
        if v is None:
            continue
        if v.device != play.device:
            if v.device.type != "cpu" or v.ndim != 0 or v.requires_grad:
                raise ValueError(
                    f"{what}: gas {k + 1}'s vmr is on {v.device}, "
                    f"{v.ndim}-D, requires grad: {v.requires_grad}; the "
                    "kernel takes host scalars that need no gradient and "
                    "tensors on the cells' device: move the gas store "
                    "there (GasConcs.to)")
            kinds[k] = 3
            values[k] = float(v)
            continue
        if v.dtype not in _DTYPES:
            raise ValueError(f"{what}: gas {k + 1}'s vmr has dtype "
                             f"{v.dtype}; the kernel takes float32 or "
                             "float64")
        cells = (tuple(play.shape) if v.ndim == 2
                 else tuple(play.shape[-v.ndim:]) if v.ndim else ())
        check_strided(what, play.device, {f"vmr {k + 1}": (v, cells,
                                                           v.dtype)})
        s = v.stride()
        ptrs[k] = v.data_ptr()
        kinds[k] = _KINDS[v.dtype]
        strides[2 * k], strides[2 * k + 1] = (
            s if v.ndim == 2 else (0, s[0]) if v.ndim == 1 else (0, 0))
    return ptrs, kinds, strides, values, n


def _check(what, play, tlay, plev, col_dry, tables):
    """The kernels' shape, dtype and stride checks; returns the dtype's
    flag for the launcher."""
    if play.ndim != 2:
        raise ValueError(f"{what}: the kernel takes (ncol, nlay) cells, got "
                         f"{tuple(play.shape)}")
    if play.dtype not in _DTYPES:
        raise ValueError(f"{what}: play has dtype {play.dtype}; the CUDA "
                         "kernel takes float32 or float64")
    ncol, nlay = play.shape
    dt = play.dtype
    check_strided(what, play.device, {
        "play": (play, (ncol, nlay), dt), "tlay": (tlay, (ncol, nlay), dt),
        "plev": (plev, (ncol, nlay + 1), dt),
        "col_dry": (col_dry, (ncol, nlay), dt)})
    nflav = tables.flavor.shape[1]
    ntemp = tables.temp_ref.shape[0]
    check_args(what, play.device, {
        "temp_ref": (tables.temp_ref, (ntemp,), dt),
        "vmr_ratio": (tables.vmr_ratio, (2, nflav, ntemp), dt),
        "flavor": (tables.flavor, (2, nflav), torch.int64)})
    return int(dt == torch.float64)


def _common(play, tlay, plev, col_dry, tables, gases, idx_h2o, layer_major,
            f64):
    """The launcher arguments both kernels share."""
    ncol, nlay = play.shape
    return (*gases, *strided(play, 2), *strided(tlay, 2), *strided(plev, 2),
            *strided(col_dry, 2), tables.temp_ref, tables.vmr_ratio,
            tables.flavor, tables.flavor.shape[1], tables.temp_ref.shape[0],
            tables.neta, int(idx_h2o), ncol, nlay, int(layer_major), f64,
            _consts(tables, play.dtype))


def _gas_descriptors_kernel(play, tlay, plev, vmrs, col_dry, idx_h2o: int,
                            tables, layer_major: bool):
    """:func:`gas_descriptors_plain` semantics as a flat tuple (col_gas,
    *InterpCoeffs); on CUDA, one launch of the hand-written kernel
    (counted in ``gas_descriptors.launches``)."""
    if on_cpu(play, "gas_descriptors"):
        col_gas, co = gas_descriptors_plain(play, tlay, plev, vmrs, col_dry,
                                            idx_h2o, tables, layer_major)
        return (col_gas, *co)
    refuse_grad("gas_descriptors", play, tlay, plev, col_dry, vmrs,
                hint="gas_descriptors differentiates it through its "
                     "adjoint")
    f64 = _check("gas_descriptors", play, tlay, plev, col_dry, tables)
    gases = _gases("gas_descriptors", vmrs, play)
    ncol, nlay = play.shape
    cells = (nlay, ncol) if layer_major else (ncol, nlay)
    nflav = tables.flavor.shape[1]
    dt, dev = play.dtype, play.device
    mk = lambda lead, dtype: torch.empty(lead + cells, dtype=dtype,
                                         device=dev)
    out = (mk((len(vmrs) + 1,), dt), mk((), torch.int32), mk((), dt),
           mk((), torch.int32), mk((), dt), mk((), torch.bool),
           mk((2, nflav), torch.int32), mk((2, nflav), dt),
           mk((2, nflav), dt))
    launch("gas_descriptors", "launch_gas_descriptors", "gas_descriptors",
           *_common(play, tlay, plev, col_dry, tables, gases, idx_h2o,
                    layer_major, f64), *out)
    gas_descriptors.launches += 1
    return out


def gas_descriptors_bwd(play, tlay, plev, vmrs, col_dry, idx_h2o: int,
                        tables, layer_major: bool, grads):
    """:func:`gas_descriptors_bwd_plain` semantics for the inputs that
    require grad; on CUDA, one launch of the hand-written adjoint kernel
    (counted in ``gas_descriptors_bwd.launches``), then, where asked, the
    levels' sums of the layers' thickness cotangents and each profile's
    or scalar's sum over its broadcast axes. On CUDA, a gas, plev or
    col_dry that does not require grad gets None."""
    if on_cpu(play, "gas_descriptors_bwd"):
        return gas_descriptors_bwd_plain(play, tlay, plev, vmrs, col_dry,
                                         idx_h2o, tables, layer_major, grads)
    refuse_grad("gas_descriptors_bwd", play, tlay, plev, col_dry, vmrs,
                grads, hint="the adjoints have no backward of their own")
    f64 = _check("gas_descriptors_bwd", play, tlay, plev, col_dry, tables)
    gases = _gases("gas_descriptors_bwd", vmrs, play)
    ncol, nlay = play.shape
    cells = (nlay, ncol) if layer_major else (ncol, nlay)
    nflav = tables.flavor.shape[1]
    dt, dev = play.dtype, play.device
    g = tuple(x.contiguous() for x in grads)
    check_args("gas_descriptors_bwd", dev, {
        "col_gas cotangent": (g[0], (len(vmrs) + 1,) + cells, dt),
        "ftemp cotangent": (g[1], cells, dt),
        "fpress cotangent": (g[2], cells, dt),
        "col_mix cotangent": (g[3], (2, nflav) + cells, dt),
        "feta cotangent": (g[4], (2, nflav) + cells, dt)})
    need = [v is not None and v.device == play.device and v.requires_grad
            for v in vmrs]
    slot = (ctypes.c_int * max(1, len(vmrs)))(*([-1] * max(1, len(vmrs))))
    nslot = 0
    for k, n in enumerate(need):
        if n:
            slot[k], nslot = nslot, nslot + 1
    mk = lambda *lead: torch.empty(lead + cells, dtype=dt, device=dev)
    dplay, dtlay = mk(), mk()
    dthick = mk() if col_dry is None and plev.requires_grad else None
    dcd = (mk() if col_dry is not None and col_dry.requires_grad
           else None)
    dvmr = mk(nslot) if nslot else None
    launch("gas_descriptors", "launch_gas_descriptors_bwd",
           "gas_descriptors_bwd",
           *_common(play, tlay, plev, col_dry, tables, gases, idx_h2o,
                    layer_major, f64),
           *g, dplay, dtlay, dcd, dthick, dvmr, slot)
    gas_descriptors_bwd.launches += 1
    dplev = (None if dthick is None
             else _levels(_layout(dthick, layer_major), plev))
    dvmrs = tuple(_sum_to(_layout(dvmr[slot[k]], layer_major), v) if n
                  else None for k, (v, n) in enumerate(zip(vmrs, need)))
    return (_layout(dplay, layer_major), _layout(dtlay, layer_major), dplev,
            None if dcd is None else _layout(dcd, layer_major), dvmrs)


gas_descriptors_bwd.launches = 0


def gas_descriptors(play, tlay, plev, vmrs, col_dry, idx_h2o: int, tables,
                    layer_major: bool):
    """col_gas (ngas+1, *S) and the :class:`InterpCoeffs` of one
    gas-optics call, each contiguous in the layout asked (S = (nlay, ncol)
    with ``layer_major``, else (ncol, nlay)): play and tlay (ncol, nlay),
    plev (ncol, nlay+1); ``vmrs`` one tensor (a scalar, (nlay,) profile or
    (ncol, nlay) field) or None (absent: zeros) per col_gas row past dry
    air; col_dry (ncol, nlay) or None (from the pressures and row
    ``idx_h2o``'s vmr); ``tables`` the k-distribution's
    :func:`ops.gas_optics.interp_tables` in play's dtype on its device. On
    CUDA one launch of the kernel (counted in
    ``gas_descriptors.launches``); differentiable in play, tlay, plev,
    col_dry and the vmr tensors, the backward one launch of the adjoint
    kernel on CUDA and the twin's autograd on the CPU."""
    # the tables, the h2o row and the layout ride in the closures, not
    # among the node's arguments, which autograd's wrapper walks
    h2o, lm = int(idx_h2o), bool(layer_major)

    def adjoint(a, g_cg, _jt, g_ft, _jp, g_fp, _tr, _je, g_cm, g_fe):
        p, t, pl, cd, vs = a
        return gas_descriptors_bwd(p, t, pl, vs, cd, h2o, tables, lm,
                                   (g_cg, g_ft, g_fp, g_cm, g_fe))

    out = with_adjoint(
        lambda p, t, pl, cd, vs: _gas_descriptors_kernel(
            p, t, pl, vs, cd, h2o, tables, lm),
        lambda p, t, pl, cd, vs: (lambda cg, co: (cg, *co))(
            *gas_descriptors_plain(p, t, pl, vs, cd, h2o, tables, lm)),
        adjoint, play, tlay, plev, col_dry, tuple(vmrs),
        name="gas_descriptors")
    return out[0], InterpCoeffs(*out[1:])


gas_descriptors.launches = 0
