#!/usr/bin/env python3
"""The costs of the PyTorch port's on-chip kernels and of the steps that
run them, for one checkout, on one CUDA GPU, at the flagship size (4096 x
72, LW 256 g-points, SW 224):

    python3 scripts/torch_step_costs.py [CHECKOUT] [--only NAME[,NAME...]]

CHECKOUT is the root of a checkout of this repository (default: the one
holding this script), so that two commits are compared on one card by
running the script on both in turns. ``--only`` times just the kernel
cases whose names start with one of the NAMEs, and no step (a variant
of one kernel, built in a copy of a checkout, in a few seconds).
It imports that checkout's ``rte_rrtmgp_tpu_torch`` and ``chip_smoke.py`` (MAIN,
NONBANDED, cuda_ms, lw2_step, step_fn, train_loss) and never JAX, and
calls only entry points that checkouts from before the SW solver's
on-chip redesign have too (the major gather gets the interleaved LW
table only where its wrapper takes one). It prints one JSON line: the card; the
CUDA-event median time of each kernel and its largest difference from its
plain twin (for the adjoint, per cotangent) over the twin's largest value:
the fused LW and SW steps and the LW two-stream solve, broadband and by
band, the major gather (row 4, LW and SW), the LW no-scattering solve
(row 7 as the public path calls it, by band, and rescaled with the
Jacobian and a secant field; row 10 on the non-banded configuration;
row 11), the minor gather (row 5, in place on a copy of the major-gas tau,
the call every checkout has, and, where the checkout's ``gas_minor`` takes
``out``, also out of place as the gas optics and chip_smoke.py's api_rows
call it; LW 256 and SW 224 g-points, each atmosphere's minors), the
Rayleigh gather (row 6 at SW 224, with ssa and split: 0 + Rayleigh, no
ssa; in place on a copy of the major-gas tau or a zeros tensor, and where
the checkout's ``gas_rayleigh`` takes ``out``, out of place as the gas
optics call it), the LW no-scattering solve's adjoint (row 14, on
chip_smoke.py's adjoint_rows inputs), the
SW solver of the public path (row 9, broadband and by band, on the path's
optics and delta-scaled clouds, night columns and mu0 varying by layer,
a diffuse incident flux), the staged path's SW lane solvers (row 12 on
the non-banded configuration, row 13 with clouds and aerosols) and the
SW solver's adjoint (row 15, seeded flux cotangents), with a digest of
each kernel's outputs, so that two checkouts' outputs are compared bit
for bit; row 15 in the tallest column a 32-wide chunk holds (see
tall_column_replay), each cotangent's distance from the float64 twin; and
for the fused
forward step, the LW two-stream step, the fused gradient step, the
public-API forward step, the staged forward step and the public-API
gradient step, the median wall time of 5 steps ending in a synchronize,
the device time per step under torch.profiler (3 steps), and of it the
copies' (kernels named copy, memcpy) and the fills' (fill, memset), and
the peak device memory of one step (torch.cuda.max_memory_allocated).
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def sw_solver_cases(cs, prob, nonb, dev):
    """{name: (kernel call, twin call)} of rows 9, 12, 13 and 15 on the
    inputs their paths give them, as chip_smoke.py's api_rows, lanes_rows
    and adjoint_rows build them."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import _scattering_lanes
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lanes as sl
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import (sw_2stream,
                                                            sw_2stream_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw_bwd import (
        sw_2stream_bwd, sw_2stream_bwd_plain)
    from rte_rrtmgp_tpu_torch.optical_props import delta_scale, increment
    inp, gs = prob.inputs, prob.gas_sw
    ncol, nlay = inp.play.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    props, toa = gs.gas_optics_sw(inp.play, inp.plev, inp.tlay,
                                  inp.gas_concs, top_at_1=True)
    props = increment(props, delta_scale(prob.cld_sw.cloud_optics(
        inp.lwp, inp.iwp, inp.rel, inp.dei)))
    col = torch.arange(ncol, device=dev)
    mu_col = torch.where(col % 16 == 0, -0.3,
                         torch.where(col % 16 == 1, 0.0, 0.86))
    layer = torch.arange(nlay, device=dev) / nlay
    mu0 = torch.where(mu_col[:, None] > 0,
                      mu_col[:, None] * (1.0 - 0.05 * layer),
                      mu_col[:, None].expand(ncol, nlay)).contiguous()
    bc = (ncol, gs.ngpt)
    inc = toa.contiguous()
    sw = (props.tau.contiguous(), props.ssa.contiguous(),
          props.g.contiguous(), mu0, rand(bc, 0.0, 0.3), rand(bc, 0.0, 0.3),
          inc, 0.05 * inc)
    nbs = dict(nband=gs.grid.nband)
    swb = sw + (gs.gpt2band,)
    cot = lambda seed: 0.5 + torch.rand(
        (ncol, nlay + 1), generator=torch.Generator(device=dev).manual_seed(
            seed), device=dev)
    alb = inp.sfc_alb.expand(*bc).contiguous()
    bwd = (sw[0], sw[1], sw[2], inp.mu0[:, None].expand(ncol, nlay)
           .contiguous(), alb, alb, inc, torch.zeros_like(inc), cot(8),
           cot(9), cot(10))

    def lanes(p, banded):
        i = p.inputs
        tau, second, top = p.gas_sw.gas_optics_sw_lanes(
            i.play, i.plev, i.tlay, i.gas_concs, split_rayleigh=banded)
        cloud = _scattering_lanes(i, p.cld_sw, True, p.aer_sw, True)
        ngpt, nl, nc = tau.shape
        m = i.mu0[None, :].expand(nl, nc)
        a = i.sfc_alb[:, 0][None, :].expand(ngpt, nc)
        if banded:
            return (tau, second, cloud, m, a, a, top, None), dict(
                gpt2band=p.gas_sw.gpt2band)
        tau, ssa, g = sl.increment_2str_bybnd(tau, second, cloud,
                                              p.gas_sw.gpt2band,
                                              torch.finfo(tau.dtype).tiny)
        return (tau, ssa, g, m, a, a, top, None), {}

    l12, k12 = lanes(nonb, False)
    l13, k13 = lanes(prob, True)
    return {
        "solver_sw": (lambda: sw_2stream(*sw), lambda: sw_2stream_plain(*sw)),
        "solver_sw byband": (lambda: sw_2stream(*swb, **nbs),
                             lambda: sw_2stream_plain(*swb, **nbs)),
        "solver_sw_lanes": (lambda: sl.sw_2stream_lanes(*l12, **k12),
                            lambda: sl.sw_2stream_lanes_plain(*l12, **k12)),
        "solver_sw_combined": (
            lambda: sl.sw_2stream_lanes_combined(*l13, **k13),
            lambda: sl.sw_2stream_lanes_combined_plain(*l13, **k13)),
        "solver_sw_bwd": (lambda: sw_2stream_bwd(*bwd),
                          lambda: sw_2stream_bwd_plain(*bwd)),
    }


def lw_solver_cases(prob, nonb, dev):
    """{name: (kernel call, twin call)} of the major-gas gather (row 4, LW
    256 g-points with the Planck fraction and SW 224 without, on the
    public path's cells; the interleaved LW table passed where the
    checkout's ``gas_major`` takes it) and the LW no-scattering solve's
    launchers: row 7 as the public path calls it (one scalar secant, no
    rescaling, no Jacobian, zero incident flux), by band, and rescaled
    with the Jacobian, an incident flux and per-(column, g-point) secants,
    on the path's gas optics and sources; row 10 on the non-banded
    configuration and row 11, clouds and aerosols on, on the staged path's
    inputs, as chip_smoke.py's api_rows and lanes_rows build them."""
    import inspect
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import _absorption_lanes
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lanes as sl
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (gas_major,
                                                            gas_major_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import (lw_noscat,
                                                            lw_noscat_plain)
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS
    inp, gl = prob.inputs, prob.gas_lw
    ncol, nlay = inp.play.shape
    out = {}
    for tag, gas in (("lw", gl), ("sw", prob.gas_sw)):
        kd = gas.kdist
        cg, _, _ = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
        a = (gas.interp(inp.play, inp.tlay, cg), kd.kmajor, kd.planck_frac,
             gas.gpoint_flavor)
        kw = ({"kmajor_pfrac": gas.kmajor_pfrac}
              if "kmajor_pfrac" in inspect.signature(gas_major).parameters
              else {})
        out[f"gas_major {tag}"] = (lambda a=a, kw=kw: gas_major(*a, **kw),
                                   lambda a=a: gas_major_plain(*a))
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    props, src = gl.gas_optics_lw(inp.play, inp.plev, inp.tlay, inp.tsfc,
                                  inp.gas_concs, tlev=inp.tlev, top_at_1=True)
    bc = (ncol, gl.ngpt)
    shape = tuple(props.tau.shape)
    emis = inp.sfc_emis[:, :1].expand(bc).contiguous()
    angle = dict(ds=float(GAUSS_DS[0][0]), weight=float(GAUSS_WTS[0][0]))
    path = (props.tau, src.lay_source, src.lev_source, emis, src.sfc_source,
            torch.zeros_like(emis))
    resc = (props.tau, src.lay_source, src.lev_source, rand(bc, 0.8, 1.0),
            src.sfc_source, rand(bc, 0.0, 2.0))
    rkw = dict(ds=gl.compute_optimal_angles(props), weight=1.0,
               sfc_src_jac=src.sfc_source_jac, ssa=rand(shape, 0.0, 0.6),
               g=rand(shape, 0.0, 0.9))
    bands = dict(angle, gpt2band=gl.gpt2band, nband=gl.grid.nband)
    for name, a, kw in (("solver_lw", path, angle),
                        ("solver_lw byband", path, bands),
                        ("solver_lw rescaled", resc, rkw)):
        out[name] = (lambda a=a, kw=kw: lw_noscat(*a, **kw),
                     lambda a=a, kw=kw: lw_noscat_plain(*a, **kw))

    def lanes(p, banded):
        i, g = p.inputs, p.gas_lw
        o = g.gas_optics_lw_lanes(i.play, i.plev, i.tlay, i.tsfc,
                                  i.gas_concs, tlev=i.tlev,
                                  banded_planck=banded)
        cld = _absorption_lanes(i, p.cld_lw, True, p.aer_lw, True)
        tau = o[0]
        ngpt, _, nc = tau.shape
        em = i.sfc_emis[:, 0][None, :].expand(ngpt, nc)
        inc = tau.new_zeros(()).expand(ngpt, nc)
        if banded:
            _, pfrac, (pbs, pbl, pbv) = o
            return (tau, pfrac, pbl, pbv, pbs, em, inc), dict(
                angle, gpt2band=g.gpt2band, cloud_tau_abs=cld)
        sfc, lay, lev, _ = o[1]
        return (tau + cld[g.gpt2band.long()], lay, lev, em, sfc, inc), angle

    l10, k10 = lanes(nonb, False)
    l11, k11 = lanes(prob, True)
    out["solver_lw_lanes"] = (lambda: sl.lw_noscat_lanes(*l10, **k10),
                              lambda: sl.lw_noscat_lanes_plain(*l10, **k10))
    out["solver_lw_pfrac"] = (
        lambda: sl.lw_noscat_lanes_pfrac(*l11, **k11),
        lambda: sl.lw_noscat_lanes_pfrac_plain(*l11, **k11))
    return out


def minor_cases(prob, cs):
    """Row 5 on the public path's inputs: each k-distribution's minors of
    each atmosphere added in place into a copy of the major-gas tau
    (``gas_minor(tau, ...)``, the call both checkouts have): {name: ms,
    largest difference from the twin over its largest value, digest}; and
    where the checkout's ``gas_minor`` takes ``out``, the out-of-place call
    of the gas optics (``_minor``): ms_out, digest_out."""
    import inspect
    import torch
    from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major_plain
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (gas_minor,
                                                            gas_minor_plain)
    inp, out = prob.inputs, {}
    for tag, gas in (("lw", prob.gas_lw), ("sw", prob.gas_sw)):
        kd = gas.kdist
        cg, _, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
        co = gas.interp(inp.play, inp.tlay, cg)
        tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
        nlo = len(kd.minor_lower)
        for lower, mset, ktab, meta in (
                (True, kd.minor_lower, kd.kminor_lower, gas.minor_meta[:nlo]),
                (False, kd.minor_upper, kd.kminor_upper,
                 gas.minor_meta[nlo:])):
            minors = tuple(m[1:] for m in gas.minors if bool(m[0]) == lower)
            sc = minor_scaling(co, mset, lower=lower, play=inp.play,
                               tlay=inp.tlay, col_gas=cg, idx_h2o=h2o)
            a = (co, ktab, minors, meta, sc)
            got = gas_minor(tau.clone(), *a)
            ref = gas_minor_plain(tau.clone(), *a)
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            sha = digest((got,))
            del got, ref
            t = tau.clone()
            row = out[f"gas_minor {tag} {'lower' if lower else 'upper'}"] = \
                dict(ms=cs.cuda_ms(lambda: gas_minor(t, *a)), rel_err=err,
                     digest=sha)
            del t
            if "out" in inspect.signature(gas_minor).parameters:
                oop = lambda: gas_minor(tau, *a, out=torch.empty_like(tau))
                row.update(digest_out=digest((oop(),)),
                           ms_out=cs.cuda_ms(oop))
    return out


def rayleigh_cases(prob, cs):
    """Row 6 at SW 224 g-points on the public path's cells: with ssa on a
    copy of the major-gas tau, and split (0 + Rayleigh, no ssa) on a zeros
    tensor, in place (``gas_rayleigh(tau, ...)``, the call both checkouts
    have): {name: ms, largest difference from the twin over its largest
    value, digest}; and where the checkout's ``gas_rayleigh`` takes
    ``out``, the gas optics' out-of-place call (``_rayleigh``: from tau,
    or from no tau for split): ms_out, digest_out."""
    import inspect
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major_plain
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (
        gas_rayleigh, gas_rayleigh_plain)
    inp, gas, out = prob.inputs, prob.gas_sw, {}
    kd = gas.kdist
    cg, dry, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
    co = gas.interp(inp.play, inp.tlay, cg)
    tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
    a = (co, kd.krayl, gas.gpoint_flavor, (cg[h2o] + dry).contiguous())
    oop = "out" in inspect.signature(gas_rayleigh).parameters
    for name, t0, scattering in (("gas_rayleigh", tau, True),
                                 ("gas_rayleigh split",
                                  torch.zeros_like(tau), False)):
        got = gas_rayleigh(t0.clone(), *a, scattering)
        ref = gas_rayleigh_plain(t0.clone(), *a, scattering)
        err = max(float((g - r).abs().max()) / float(r.abs().max())
                  for g, r in zip(got, ref) if g is not None)
        sha = digest(got)
        del got, ref
        t = t0.clone()
        row = out[name] = dict(ms=cs.cuda_ms(lambda: gas_rayleigh(
            t, *a, scattering)), rel_err=err, digest=sha)
        del t
        if oop:
            src = tau if scattering else None
            call = lambda: gas_rayleigh(src, *a, scattering,
                                        out=torch.empty_like(tau))
            row.update(digest_out=digest(call()), ms_out=cs.cuda_ms(call))
    return out


def lw_adjoint_case(prob, dev):
    """{"solver_lw_bwd": (kernel call, twin call)}: row 14 on chip_smoke.py
    adjoint_rows' inputs at the flagship size (the public path's optics
    with the clouds' absorption, its sources, zero incident flux, flux
    cotangents 0.5 + uniform from seeds 6 and 7, the first Gauss secant,
    weight 1)."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_bwd import (
        lw_noscat_bwd, lw_noscat_bwd_plain)
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS
    from rte_rrtmgp_tpu_torch.optical_props import increment
    i, gl = prob.inputs, prob.gas_lw
    ncol, nlay = i.play.shape
    props, src = gl.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                  i.gas_concs, tlev=i.tlev, top_at_1=True)
    props = increment(props, prob.cld_lw.cloud_optics(
        i.lwp, i.iwp, i.rel, i.dei, scattering=False))
    ngpt = props.tau.shape[2]
    emis = i.sfc_emis.expand(ncol, ngpt).contiguous()
    cot = lambda seed: 0.5 + torch.rand(
        (ncol, nlay + 1), generator=torch.Generator(device=dev).manual_seed(
            seed), device=dev)
    a = (props.tau.contiguous(), src.lay_source, src.lev_source, emis,
         src.sfc_source, torch.zeros_like(emis), cot(6), cot(7))
    kw = dict(ds=float(GAUSS_DS[0][0]), weight=1.0)
    return {"solver_lw_bwd": (lambda: lw_noscat_bwd(*a, **kw),
                              lambda: lw_noscat_bwd_plain(*a, **kw))}


def digest(outs):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def tall_column_replay(cs, dev):
    """Row 15 at 162 layers and 224 g-points, 4 columns, mu0 drawn per
    layer in [0.3, 0.9], k mu0 up to the clamp at 1: the inputs that
    chip_smoke.py's onchip_limits drew from numpy's default_rng(21) before
    its mu0 range became [0.2, 0.3] (after the SW solve's draws for 355
    and 356 layers). For each cotangent, the kernel's and the float32
    twin's largest distance from the float64 twin (the float32 algorithm
    in float64 arithmetic) over the float64 twin's largest value, and
    where the kernel's distance lies: (column, layer, g-point), mu0 and k
    mu0 there."""
    import numpy as np
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw_bwd import (
        sw_2stream_bwd, sw_2stream_bwd_plain)
    ncol, ngpt = 4, 224
    rng = np.random.default_rng(21)

    def args(nlay, mu_lo, mu_hi, cots):
        u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(
            np.float32)
        inc = u(0.5, 2.0, ncol, ngpt)
        a = (u(0.0, 0.1, ncol, nlay, ngpt), u(0.0, 0.9, ncol, nlay, ngpt),
             u(0.0, 0.8, ncol, nlay, ngpt), u(mu_lo, mu_hi, ncol, nlay),
             u(0.0, 0.3, ncol, ngpt), u(0.0, 0.3, ncol, ngpt), inc,
             np.float32(0.05) * inc)
        return a + tuple(u(0.5, 1.5, ncol, nlay + 1) for _ in range(cots))

    args(355, 0.3, 0.9, 0)
    args(356, 0.3, 0.9, 0)
    a = args(162, 0.3, 0.9, 3)
    x = tuple(torch.from_numpy(v).to(dev) for v in a)
    got, ref = sw_2stream_bwd(*x), sw_2stream_bwd_plain(*x)
    with cs.float32_constants():
        ref64 = sw_2stream_bwd_plain(*cs.to_f64(x))
    tau, ssa, asy, mu0 = (v.astype(np.float64) for v in a[:4])
    g1 = (8.0 - ssa * (5.0 + 3.0 * asy)) / 4.0
    g2 = 3.0 * ssa * (1.0 - asy) / 4.0
    kmu = np.sqrt(np.maximum((g1 - g2) * (g1 + g2), 1e4 * 2.0 ** -23)) * (
        mu0[:, :, None])
    out = dict(digest=digest(got), cotangents=[])
    for g, r, r64 in zip(got, ref, ref64):
        scale = float(r64.abs().max())
        d = (g.double() - r64).abs()
        at = np.unravel_index(int(d.argmax()), tuple(d.shape))
        row = dict(kernel=float(d.max()) / scale,
                   twin=float((r.double() - r64).abs().max()) / scale,
                   at=[int(i) for i in at])
        if len(at) == 3:
            row.update(mu0=float(mu0[at[0], at[1]]), kmu=float(kmu[at]))
        out["cotangents"].append(row)
    return out


def main():
    args, only = sys.argv[1:], None
    if "--only" in args:
        i = args.index("--only")
        only = tuple(args[i + 1].split(","))
        del args[i:i + 2]
    root = os.path.abspath(args[0] if args else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir))
    sys.path.insert(0, root)
    want = lambda name: only is None or name.startswith(only)
    import torch
    if not torch.cuda.is_available():
        print("torch_step_costs: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs,
                                                     build_allsky,
                                                     build_allsky_step)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (sw_fused,
                                                           sw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (
        lw_2stream, lw_2stream_plain)
    from rte_rrtmgp_tpu_torch.optical_props import increment

    dev = torch.device("cuda", 0)
    out = {"checkout": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    prob = build_allsky(**cs.MAIN, device=dev)
    i = prob.inputs
    x = allsky_sw_inputs(i, prob.gas_sw, cloud_optics=prob.cld_sw)
    props, src = prob.gas_lw.gas_optics_lw(
        i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
        scattering=True, top_at_1=True)
    props = increment(props, prob.cld_lw.cloud_optics(
        i.lwp, i.iwp, i.rel, i.dei, scattering=True))
    ncol, _, ngpt = props.tau.shape
    emis = i.sfc_emis.expand(ncol, ngpt).contiguous()
    lw = (props.tau.contiguous(), props.ssa.contiguous(),
          props.g.contiguous(), src.lay_source, src.lev_source, emis,
          src.sfc_source, torch.zeros_like(emis))
    del props, src
    bands = (prob.gas_lw.gpt2band,)
    nb = dict(nband=prob.gas_lw.grid.nband)
    xb = x._replace(byband=True)
    xl = allsky_lw_inputs(i, prob.gas_lw, cloud_optics=prob.cld_lw)
    xlb = xl._replace(byband=True)
    cases = [
        ("fused_lw", lambda: lw_fused(xl), lambda: lw_fused_plain(xl)),
        ("fused_lw byband", lambda: lw_fused(xlb),
         lambda: lw_fused_plain(xlb)),
        ("fused_sw", lambda: sw_fused(x), lambda: sw_fused_plain(x)),
        ("fused_sw byband", lambda: sw_fused(xb),
         lambda: sw_fused_plain(xb)),
        ("solver_lw_2str", lambda: lw_2stream(*lw),
         lambda: lw_2stream_plain(*lw)),
        ("solver_lw_2str byband", lambda: lw_2stream(*lw, *bands, **nb),
         lambda: lw_2stream_plain(*lw, *bands, **nb))]
    cases = [c for c in cases if want(c[0])]
    got = ref = None
    for name, kernel, plain in cases:
        got, ref = kernel(), plain()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        out[name] = dict(ms=cs.cuda_ms(kernel), rel_err=err / scale,
                         digest=digest(got))
    del x, xb, xl, xlb, lw, got, ref, cases
    torch.cuda.empty_cache()
    if want("gas_minor"):
        out.update(minor_cases(prob, cs))
        torch.cuda.empty_cache()
    if want("gas_rayleigh"):
        out.update(rayleigh_cases(prob, cs))
        torch.cuda.empty_cache()

    cases = lw_adjoint_case(prob, dev) if want("solver_lw_bwd") else {}
    aer = nonb = None
    if any(want(n) for n in ("gas_major", "solver_lw", "solver_sw")):
        aer = build_allsky(**cs.MAIN, device=dev, use_aerosols=True)
        nonb = build_allsky(**cs.NONBANDED, device=dev, use_aerosols=True)
        cases.update(lw_solver_cases(aer, nonb, dev))
        cases.update(sw_solver_cases(cs, aer, nonb, dev))
    cases = {k: v for k, v in cases.items() if want(k)}
    kernel = plain = None
    for name, (kernel, plain) in cases.items():
        got, ref = (tuple(x for x in f() if x is not None)
                    for f in (kernel, plain))
        if name.endswith("_bwd"):
            err = [float((g - r).abs().max()) / float(r.abs().max())
                   for g, r in zip(got, ref)]
        else:
            err = (max(float((g - r).abs().max()) for g, r in zip(got, ref))
                   / max(float(r.abs().max()) for r in ref))
        sha = digest(got)
        del got, ref
        torch.cuda.empty_cache()
        out[name] = dict(ms=cs.cuda_ms(kernel), rel_err=err, digest=sha)
    # the cases' inputs (about 2 GB) must not count in the steps' peaks
    del aer, nonb, kernel, plain, cases
    torch.cuda.empty_cache()
    if want("solver_sw_bwd tallest column"):
        out["solver_sw_bwd tallest column"] = tall_column_replay(cs, dev)
        torch.cuda.empty_cache()
    if only is not None:
        print(json.dumps(out), flush=True)
        return 0

    step, inputs = build_allsky_step(**cs.MAIN, device=dev)
    lw2 = cs.lw2_step(prob)
    api, staged = cs.step_fn(prob, "api"), cs.step_fn(prob, "staged")
    for name, fn in (("fused step", lambda: step(inputs)),
                     ("two-stream step", lambda: lw2(inputs)),
                     ("fused gradient step",
                      lambda: cs.train_loss(step, inputs)),
                     ("public API step", lambda: api(inputs)),
                     ("staged step", lambda: staged(inputs)),
                     ("public API gradient step",
                      lambda: cs.train_loss(api, inputs))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = lambda es: sum(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0))
                            for e in es) / 3e3
        named = lambda *ws: [e for e in on_card
                             if any(w in e.key.lower() for w in ws)]
        out[name] = dict(wall_ms=statistics.median(walls) * 1e3,
                         device_ms=ms(on_card),
                         copy_ms=ms(named("copy", "memcpy")),
                         fill_ms=ms(named("fill", "memset")),
                         peak_bytes=peak)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
