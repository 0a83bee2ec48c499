"""Digests of the outputs of the kernels that share device code with the
fused LW step and the minor-gas gather (``csrc/common.cuh``,
``csrc/transport.cuh``), at two small cases, which
``tests/golden/kernel_digests_frozen.json`` records: rows 2 (the fused LW
step), 3 (the fused SW step), 5 (the minor-gas gather), 6 (the Rayleigh
gather) and 16 (the fused LW adjoint), on tests/test_torch_cuda.py's
DIMS["g24"] (7 columns, 12 layers, LW 24 g-points / 3 bands, SW 40 / 5)
and its FLAGSHIP (3 columns, 72 layers, LW 256 / 16, SW 224 / 14), clouds
on; incident fluxes and flux cotangents uniform from numpy's
default_rng(17). Each entry "<case> <kernel> <variant>" is the first 16
hex digits of the SHA-256 of the returned tensors' bytes, in order. The
record holds the minor gathers in place (``gas_minor(tau, ...)``, the only
call of the checkout it was taken from); ``record(dev, minor_out=True)``
takes them out of place, as the gas optics call them
(``models/rrtmgp/gas_optics.py::_minor``), under the same names. Used by
tests/test_torch_cuda.py::test_kernels_match_frozen_digests and by
scripts/freeze_kernel_digests.py, which writes the record.
"""
import hashlib

import numpy as np

CASES = {"g24": (7, 12, 24, 3, 40, 5, 6, 11),
         "flagship": (3, 72, 256, 16, 224, 14, 14, 59)}


def digest(outs):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _gathers(p, gas, sw, minor_out):
    """(name, call) of the minor gathers of both atmospheres and, for SW,
    the Rayleigh gather, each on a fresh copy of the major-gas tau (with
    ``minor_out``, the minor gathers from tau into a new tensor)."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major_plain
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (gas_minor,
                                                            gas_rayleigh)
    inp, kd = p.inputs, gas.kdist
    cg, dry, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
    co = gas.interp(inp.play, inp.tlay, cg)
    tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
    nlo = len(kd.minor_lower)
    out = []
    for lower, mset, ktab, meta in (
            (True, kd.minor_lower, kd.kminor_lower, gas.minor_meta[:nlo]),
            (False, kd.minor_upper, kd.kminor_upper, gas.minor_meta[nlo:])):
        minors = tuple(m[1:] for m in gas.minors if bool(m[0]) == lower)
        sc = minor_scaling(co, mset, lower=lower, play=inp.play,
                           tlay=inp.tlay, col_gas=cg, idx_h2o=h2o)
        out.append(("lower" if lower else "upper",
                    lambda ktab=ktab, minors=minors, meta=meta, sc=sc: (
                        gas_minor(tau, co, ktab, minors, meta, sc,
                                  out=torch.empty_like(tau))
                        if minor_out else
                        gas_minor(tau.clone(), co, ktab, minors, meta, sc),)))
    if sw:
        rs = (cg[h2o] + dry).contiguous()
        out.append(("rayleigh", lambda: gas_rayleigh(
            tau.clone(), co, kd.krayl, gas.gpoint_flavor, rs, True)))
    return out


def record(dev, minor_out=False):
    """{"<case> <kernel> <variant>": digest} at CASES on ``dev``; with
    ``minor_out`` the minor gathers out of place."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs,
                                                     build_allsky)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_bwd)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import sw_fused
    out = {}
    for tag, dims in CASES.items():
        p = build_allsky(*dims, device=dev)
        xl = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
        xs = allsky_sw_inputs(p.inputs, p.gas_sw, cloud_optics=p.cld_sw)
        nlay, ncol = xl.tlay.shape
        rng = np.random.default_rng(17)
        u = lambda *s: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(
            np.float32)).to(dev)
        inc = u(*xl.inc.shape)
        incdif = 0.05 * xs.inc * u(*xs.inc.shape)
        cots = (u(nlay + 1, ncol), u(nlay + 1, ncol))
        calls = [
            ("fused_lw broadband", lambda: lw_fused(xl)),
            ("fused_lw byband", lambda: lw_fused(xl._replace(byband=True))),
            ("fused_lw inc", lambda: lw_fused(xl._replace(inc=inc))),
            ("fused_lw clear", lambda: lw_fused(
                xl._replace(cloud_tau_abs=None))),
            ("fused_sw broadband", lambda: sw_fused(xs)),
            ("fused_sw byband", lambda: sw_fused(xs._replace(byband=True))),
            ("fused_sw incdif", lambda: sw_fused(xs._replace(
                incdif=incdif))),
            ("fused_lw_bwd broadband", lambda: lw_fused_bwd(xl, *cots))]
        calls += [(f"gas_minor lw {n}", f) for n, f in _gathers(
            p, p.gas_lw, False, minor_out)]
        calls += [(f"gas_minor sw {n}" if n != "rayleigh"
                   else "gas_rayleigh sw", f)
                  for n, f in _gathers(p, p.gas_sw, True, minor_out)]
        for name, call in calls:
            out[f"{tag} {name}"] = digest(call())
    return out
