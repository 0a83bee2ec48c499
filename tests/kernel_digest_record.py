"""Digests of the outputs of the kernels that share device code with the
fused LW step and the minor-gas gather (``csrc/common.cuh``,
``csrc/transport.cuh``), at two small cases, which
``tests/golden/kernel_digests_frozen.json`` records: rows 2 (the fused LW
step), 3 (the fused SW step), 5 (the minor-gas gather), 6 (the Rayleigh
gather, with ssa, and its split variant: 0 + Rayleigh, no ssa) and 16
(the fused LW adjoint); and rows 4 (the major-gas gather, LW with the
Planck fraction and SW), 7 (the LW no-scattering solve: one scalar secant
broadband, as the public path calls it, by band, and rescaled with the
Jacobian and a secant field), 10 (its lane layout, plain and rescaled
with the Jacobian) and 11 (with in-kernel Planck sources, with and
without cloud), the solvers on inputs drawn from numpy's default_rng(23)
at the case's widths; and row 14 (the LW no-scattering solve's adjoint)
on the public path's optics and sources with clouds, zero incident flux
and seeded flux cotangents, as chip_smoke.py's adjoint_rows builds them;
on tests/test_torch_cuda.py's DIMS["g24"] (7 columns, 12 layers, LW 24
g-points / 3 bands, SW 40 / 5) and its FLAGSHIP (3 columns, 72 layers, LW
256 / 16, SW 224 / 14), clouds on; incident fluxes and flux cotangents
uniform from numpy's default_rng(17). Each entry "<case> <kernel>
<variant>" is the first 16 hex digits of the SHA-256 of the returned
tensors' bytes, in order. The record holds the minor and Rayleigh gathers
in place (``gas_minor(tau, ...)``, ``gas_rayleigh(tau, ...)``, the split
variant on a zeros tensor: the calls of the checkouts it was taken from);
``record(dev, out_of_place=True)`` takes them out of place, as the gas
optics call them (``models/rrtmgp/gas_optics.py::_minor``, ``_rayleigh``:
the split variant from no tau at all), under the same names. Used by
tests/test_torch_cuda.py::test_kernels_match_frozen_digests and by
scripts/freeze_kernel_digests.py, which writes the record. Every call
goes through an entry point that checkouts from before the LW solver and
the major gather were rewritten have too; the major gather gets the
interleaved LW table only where its wrapper takes one. The record holds
the outputs of the kernels before each was rewritten, but for row 11's
four entries: the rewritten kernel's, which nvcc compiles to other bits
(an ulp or two, PERF.md), and row 14's two entries: its rewritten
kernel's, whose tau cotangent nvcc fuses otherwise (PERF.md lists the
parent's). Row 6's split entries were taken from the checkout before it
was rewritten.
"""
import hashlib
import inspect

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


def _gathers(p, gas, sw, out_of_place):
    """(name, call) of the minor gathers of both atmospheres and, for SW,
    the Rayleigh gather and its split variant (0 + Rayleigh, no ssa), each
    on a fresh copy of the major-gas tau or a zeros tensor (with
    ``out_of_place``, from tau into a new tensor, the split variant from
    no tau)."""
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
                        if out_of_place else
                        gas_minor(tau.clone(), co, ktab, minors, meta, sc),)))
    if sw:
        rs = (cg[h2o] + dry).contiguous()
        ray = (co, kd.krayl, gas.gpoint_flavor, rs)
        if out_of_place:
            out += [("rayleigh", lambda: gas_rayleigh(
                        tau, *ray, True, out=torch.empty_like(tau))),
                    ("rayleigh split", lambda: gas_rayleigh(
                        None, *ray, False, out=torch.empty_like(tau)))]
        else:
            out += [("rayleigh", lambda: gas_rayleigh(tau.clone(), *ray,
                                                      True)),
                    ("rayleigh split", lambda: gas_rayleigh(
                        torch.zeros_like(tau), *ray, False))]
    return out


def _major(p, gas):
    """(name, call) of the major-gas gather on the gas optics' cells (with
    the Planck fraction for LW), passing the interleaved table
    (``GasOpticsRRTMGP.kmajor_pfrac``) where the wrapper takes it."""
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major
    inp, kd = p.inputs, gas.kdist
    cg, _, _ = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
    co = gas.interp(inp.play, inp.tlay, cg)
    kw = {}
    if "kmajor_pfrac" in inspect.signature(gas_major).parameters:
        kw["kmajor_pfrac"] = gas.kmajor_pfrac
    return lambda: gas_major(co, kd.kmajor, kd.planck_frac,
                             gas.gpoint_flavor, **kw)


def _lw_solvers(p, dev):
    """(name, call) of the LW no-scattering solve's three launchers (rows
    7, 10, 11) on inputs from numpy's default_rng(23) at the problem's
    widths: optical depths spanning the small-tau series and the
    exponential (1e-6 to 10), the lane solvers on permuted views of the
    public layout, as the staged path passes the gathers' output."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lanes import (
        lw_noscat_lanes, lw_noscat_lanes_pfrac)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import lw_noscat
    gl = p.gas_lw
    ncol, nlay = p.inputs.play.shape
    ngpt, nbnd, g2b = gl.ngpt, gl.grid.nband, gl.gpt2band
    rng = np.random.default_rng(23)
    u = lambda lo, hi, *s: torch.from_numpy(rng.uniform(lo, hi, s).astype(
        np.float32)).to(dev)
    lay3 = (ncol, nlay, ngpt)
    tau = torch.from_numpy((10.0 ** rng.uniform(-6.0, 1.0, lay3)).astype(
        np.float32)).to(dev)
    lay, lev = u(0.5, 1.5, *lay3), u(0.5, 1.5, ncol, nlay + 1, ngpt)
    emis, sfc = u(0.8, 1.0, ncol, ngpt), u(0.5, 1.5, ncol, ngpt)
    inc, jac = u(0.0, 0.5, ncol, ngpt), u(0.0, 0.1, ncol, ngpt)
    ssa, asy = u(0.0, 0.6, *lay3), u(0.0, 0.9, *lay3)
    ds = u(1.0, 2.0, ncol, ngpt)
    pf = u(0.0, 1.0, *lay3)
    pbl, pbv = u(0.5, 1.5, nbnd, nlay, ncol), u(0.5, 1.5, nbnd, nlay + 1,
                                                ncol)
    pbs, cld = u(0.5, 1.5, nbnd, ncol), u(0.0, 0.5, nbnd, nlay, ncol)
    t3 = lambda x: x.permute(2, 1, 0)
    one = dict(ds=1.66, weight=0.5)
    lanes = (t3(tau), t3(lay), t3(lev), emis.T, sfc.T, inc.T)
    return [
        ("solver_lw path", lambda: lw_noscat(tau, lay, lev, emis, sfc, inc,
                                             **one)),
        ("solver_lw byband", lambda: lw_noscat(
            tau, lay, lev, emis, sfc, inc, gpt2band=g2b, nband=nbnd,
            **one)),
        ("solver_lw rescaled", lambda: lw_noscat(
            tau, lay, lev, emis, sfc, inc, ds=ds, weight=0.5,
            sfc_src_jac=jac, ssa=ssa, g=asy)),
        ("solver_lw_lanes plain", lambda: lw_noscat_lanes(*lanes, **one)),
        ("solver_lw_lanes rescaled", lambda: lw_noscat_lanes(
            *lanes, ssa=t3(ssa), g=t3(asy), sfc_src_jac=jac.T,
            do_rescaling=True, do_jacobians=True, **one)),
        ("solver_lw_pfrac cloud", lambda: lw_noscat_lanes_pfrac(
            t3(tau), t3(pf), pbl, pbv, pbs, emis.T, inc.T, gpt2band=g2b,
            cloud_tau_abs=cld, **one)),
        ("solver_lw_pfrac clear", lambda: lw_noscat_lanes_pfrac(
            t3(tau), t3(pf), pbl, pbv, pbs, emis.T, inc.T, gpt2band=g2b,
            **one))]


def _lw_adjoint(p, dev):
    """Row 14 on the public path's optics (the gas optics plus the clouds'
    absorption) and sources, zero incident flux and flux cotangents
    0.5 + uniform from torch.Generator seeds 6 and 7 on ``dev``, the
    Gauss secant of one angle and weight 1: chip_smoke.py's adjoint_rows'
    inputs at the case's size."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_bwd import lw_noscat_bwd
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS
    from rte_rrtmgp_tpu_torch.optical_props import increment
    i, gl = p.inputs, p.gas_lw
    ncol, nlay = i.play.shape
    props, src = gl.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                  i.gas_concs, tlev=i.tlev, top_at_1=True)
    props = increment(props, p.cld_lw.cloud_optics(
        i.lwp, i.iwp, i.rel, i.dei, scattering=False))
    ngpt = props.tau.shape[2]
    emis = i.sfc_emis.expand(ncol, ngpt).contiguous()
    cot = lambda seed: 0.5 + torch.rand(
        (ncol, nlay + 1), generator=torch.Generator(device=dev).manual_seed(
            seed), device=dev)
    a = (props.tau.contiguous(), src.lay_source, src.lev_source, emis,
         src.sfc_source, torch.zeros_like(emis), cot(6), cot(7))
    return lambda: lw_noscat_bwd(*a, ds=float(GAUSS_DS[0][0]), weight=1.0)


def record(dev, out_of_place=False):
    """{"<case> <kernel> <variant>": digest} at CASES on ``dev``; with
    ``out_of_place`` the minor and Rayleigh gathers out of place."""
    return {name: digest(call()) for name, call in _calls(dev, out_of_place)}


def outputs(dev, match):
    """{"<case> <kernel> <variant>": the returned tensors, on the CPU} of
    the entries whose name holds ``match``: what the digests are taken
    of, for comparing two checkouts element by element."""
    return {name: tuple(t.detach().cpu() for t in call() if t is not None)
            for name, call in _calls(dev, False) if match in name}


def _calls(dev, out_of_place):
    """("<case> <kernel> <variant>", call) of every entry, case by case."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs,
                                                     build_allsky)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_bwd)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import sw_fused
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
            p, p.gas_lw, False, out_of_place)]
        ray = {"rayleigh": "gas_rayleigh sw",
               "rayleigh split": "gas_rayleigh sw split"}
        calls += [(ray.get(n, f"gas_minor sw {n}"), f)
                  for n, f in _gathers(p, p.gas_sw, True, out_of_place)]
        calls += [("gas_major lw", _major(p, p.gas_lw)),
                  ("gas_major sw", _major(p, p.gas_sw))]
        calls += _lw_solvers(p, dev)
        calls.append(("solver_lw_bwd path", _lw_adjoint(p, dev)))
        for name, call in calls:
            yield f"{tag} {name}", call
