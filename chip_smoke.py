#!/usr/bin/env python3
"""Run the PyTorch port's three all-sky paths, the LW two-stream path, and
gradient steps through two of them, on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from rte_rrtmgp_tpu_torch/csrc (nvcc, one
     process per source, in parallel) and print the build time;
  3. each kernel against its plain-PyTorch twin on the device at the
     shapes its path gives it (4096 x 72, LW 256 g-points / 16 bands,
     SW 224 / 14, ntemp 14, npres 59; the staged path's plain lane
     solvers on the non-banded configuration, LW 192 / 16 and SW 168 / 14,
     the only one on which the JAX package's dispatch reaches them; the
     lane solvers with clouds and aerosols; the LW two-stream kernel on
     the two-stream path's inputs, clouds at scattering=True), with the
     median CUDA-event time of both and the card's lower bound for the same
     work; the four adjoint kernels against the twins' autograd on the same
     inputs and seeded flux cotangents (see TOL_ADJ); then the variants
     the paths can ask for, each against its twin and timed, logged but
     not in the kernels line: by-band output of the fused LW and SW steps
     and of the LW no-scattering, LW two-stream and SW solvers, the fused
     steps with an incident flux (LW) and a diffuse one (SW), and their
     adjoints with the same; for the four adjoints their ptxas registers
     and spills, resident blocks per SM and scratch bytes;
  4. golden gates at the production configuration (256 x 72): the float32
     fused step, public-API path and staged path against
     tests/golden/production.npz, and the float32 aerosols step (fused)
     against the port's float64 twin of that step on the CPU, each field
     within 3x tests/golden/production_f32_noise.json; the fused path's
     d(TOA LW up)/d(tsfc) against the analytic surface Jacobian, and the
     float32 training-loss gradients against the float64 twin's on the
     CPU (printed as the gradient noise floor); the float32 LW two-stream
     path against the port's float64 twin of it on the CPU (no two-stream
     golden is committed), within the same 3x noise floor;
  5. the paths at 4096 x 72, each with the launch counters set to 0 just
     before it, the kernels it must and must not launch, finite
     non-negative outputs, TOA SW down equal to the solar source times
     mu0, and its median step time: the fused path
     (build_allsky_step(...) then step(inputs)); the public-API path
     (gas_optics_lw/sw -> cloud_optics -> increment -> rte_lw/rte_sw);
     the staged lane-layout path (allsky_staged_lw/sw), banded and on the
     non-banded configuration; the aerosols configuration on the fused,
     staged and public-API paths; the clear-sky configuration on the
     fused and staged paths (no cloud optics launched). Every path is
     held against the fused one on the same inputs within rtol 3e-5 /
     atol 5e-4 W/m2. The fused step by band, its band sums against its
     broadband fluxes; the LW two-stream path (gas_optics_lw(scattering=
     True) -> cloud_optics(scattering=True) -> increment -> rte_lw(
     use_2stream=True)), broadband and by band, the two-stream kernel once
     per step and no no-scattering solver, finite non-negative fluxes, the
     band sums against the broadband fluxes; then where the time goes
     (torch.profiler over 3 steps of the fused, public-API, staged,
     aerosols fused and two-stream paths: device time by kernel, device
     busy share); then two gradient steps
     (forward + backward of a weighted flux loss) on the fused path with
     clouds, then with aerosols, and on the public-API path, with the
     adjoint kernels each launched once per step, gradients finite and
     bit-identical over the two, the step time beside the forward's, the
     fused step's peak device memory and its profile;
  6. rte_lw with 3 quadrature angles and with compute_optimal_angles
     secants, on the card against the twins on the CPU (512 columns); the
     secant of lw_solver_noscat as a tuple, a 0-d tensor, a 1-D tensor and
     a tuple holding a 0-d tensor: bit-identical fluxes on the card;
  7. a ``{"kernels": [...]}`` line (launches from the path that runs each
     kernel: the fused path for the fused kernels and cloud optics, the
     public-API path for the gathers and the public solvers, the staged
     paths for the lane solvers, the two-stream path for its kernel, the
     gradient steps for the adjoints),
     then the last line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before doing anything.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN = dict(ncol=4096, nlay=72, ngpt_lw=256, nbnd_lw=16, ngpt_sw=224,
            nbnd_sw=14, ntemp=14, npres=59)
PROD = dict(MAIN, ncol=256)
# bands of 12 g-points: the staged path takes the plain lane solvers
NONBANDED = dict(MAIN, ngpt_lw=192, ngpt_sw=168)
# kernel vs twin, same float32 inputs: the two differ only in summation
# order, fused multiply-adds and expf's last bit. The gathers (cloud
# optics, major/minor/Rayleigh) are lerps of a few products per value;
# the solvers and fused steps sum 224-256 g-points over 72-layer
# recurrences. Bounds are relative to the largest twin value (measured
# on an H100: gathers below 1e-7, fluxes about 2e-7).
TOL_GATHER = 1e-6    # x max |twin|
TOL_FLUX = 2e-6      # x max |twin| (about 3e-3 W/m2 on LW fluxes)
# public-API path vs the fused path, same inputs (the JAX package's own
# bound for its fused-vs-generic test, tests/test_pallas_gas_optics.py:275)
PATH_RTOL, PATH_ATOL = 3e-5, 5e-4
REPS = 5
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bandwidth and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float operations per unit of work, counted from the kernels' arithmetic
# (an exp or a division counts as one)
OPS_MAJOR_CORNER = 5       # weight (2), x col_mix, multiply-add
OPS_PFRAC_CORNER = 2
OPS_MINOR = 16             # per (cell, g-point) a minor gas covers
OPS_RAYLEIGH = 18          # 2-D lerp (14), x scale, combine (3)
OPS_CLOUD = 27             # per (cell, band): 2 phases x (3 lerps + 3)
OPS_LW_LAYER = 24          # per (column, layer, g-point): source, sweeps
OPS_LW_RESCALE = 14        # Tang terms and the second down sweep
OPS_PLANCK = 12            # totplnk lerps, level geometric mean
OPS_SW_LAYER = 62          # Meador-Weaver (47), direct beam, adding (12)
OPS_SW_COMBINE = 12        # Rayleigh and cloud combine
OPS_PFRAC_SOURCES = 8      # layer source, two level geometric means, cloud
# per (column, layer, g-point) of the LW two-stream solve: Meador-Weaver
# Rdif/Tdif (21), the Toon sources (27), the adding build and sweep (19),
# the level sums (2)
OPS_LW2_LAYER = 69
# the adjoints, per (column, layer, g-point): the layer terms recomputed
# twice and the sweeps' and sources' adjoints (LW); the coefficients,
# beam and adding recomputed, their adjoints and the Meador-Weaver chain
# transposed (SW); per corner of the major lookup, its five cotangents
OPS_LW_ADJ = 70
OPS_SW_ADJ = 300
OPS_MAJOR_ADJ_CORNER = 14
OPS_MINOR_ADJ = 12         # per (cell, g-point) a minor gas covers
OPS_RAYLEIGH_ADJ = 12
OPS_COMBINE_ADJ = 30       # Rayleigh combine and cloud increment transposed
# an adjoint kernel against the twin's autograd, same float32 inputs and
# cotangents: each cotangent within this share of its largest twin value
# (the JAX package's float32 bound, tests/test_fused_autodiff.py:641-642).
# A cotangent whose float32 twin misses that bound against the twin run
# in float64 (with the float32 eps and tiny that the kernels use in
# every dtype: the same algorithm in exact-enough arithmetic), as the
# descriptor and cloud cotangents of nearly transparent upper layers
# and the ssa cotangent at the min_k clamp do, is held to the same bound
# against that float64 twin instead.
TOL_ADJ = 5e-4
# the LW two-stream solve is ill-conditioned in float32: just above the
# thin-layer threshold (tau 1e-8) its Toon sources subtract terms of size
# |dB / (tau (g1 + g2))|, so the float32 twin itself is 3e-4 of the
# largest flux from a float64 run on the same inputs (64 columns of the
# flagship problem, CPU), and the kernel's other rounding (fused
# multiply-adds, expf) moves the fluxes by as much. There the kernel is
# held to the float64 twin instead, no further than this many times the
# float32 twin is (see check_kernel).
TOL_COND = 2.0


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=REPS, burst_ms=10.0):
    """Median over ``reps`` bursts of fn's device time per call, in ms.
    A burst repeats fn back to back for about ``burst_ms``, so that for a
    short kernel the host's launch overhead overlaps the device's work
    instead of being timed as idle device time."""
    import torch

    def burst(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    fn()                                                  # warm-up
    n = max(1, min(1000, int(burst_ms / burst(1))))
    return statistics.median(burst(n) for _ in range(reps))


def as_tuple(x):
    return tuple(v for v in (x if isinstance(x, tuple) else (x,))
                 if v is not None)


def nbytes(*xs):
    """Bytes of every tensor in xs (nested tuples included), each once."""
    import torch
    seen, total = set(), 0
    stack = list(xs)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += min(x.numel() * x.element_size(),
                             x.untyped_storage().nbytes())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def bound(moved_bytes, ops):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is larger."""
    t_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved_bytes, ops=ops)


def check_kernel(name, kernel, plain, args, tol, source, replaces, work,
                 fresh=lambda a: a, ill_conditioned=False):
    """Kernel vs twin on fresh copies of the inputs (``fresh`` clones what
    a kernel updates in place), then both timed. ``work`` is (bytes the
    function must move, its operations). With ``ill_conditioned``, a
    kernel beyond ``tol`` of its float32 twin passes when it is no further
    than TOL_COND times the float32 twin from the twin run in float64
    (with float32's constants) on the same inputs: the float32 rounding
    of the function itself, not of one implementation, sets the gap."""
    import torch
    got = as_tuple(kernel(fresh(args)))
    ref = as_tuple(plain(fresh(args)))
    torch.cuda.synchronize()
    if len(got) != len(ref):
        raise SystemExit(f"{name}: kernel gives {len(got)} outputs, twin "
                         f"{len(ref)}")
    for g, r in zip(got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{name}: kernel output {tuple(g.shape)} is "
                             f"not finite or not {tuple(r.shape)}")
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    agrees = err <= tol * scale
    if not agrees and ill_conditioned:
        with float32_constants():
            ref64 = as_tuple(plain(to_f64(args)))
        gap = lambda xs: max(float((x.double() - r).abs().max())
                             for x, r in zip(xs, ref64)) / scale
        k64, t64 = gap(got), gap(ref)
        log(f"kernel {name}: against the float64 twin, kernel {k64:.3e}, "
            f"float32 twin {t64:.3e} of the largest value (limit "
            f"{TOL_COND} x the float32 twin's)")
        agrees = k64 <= TOL_COND * t64
        del ref64
    del got, ref
    ms = cuda_ms(lambda: kernel(args))
    plain_ms = cuda_ms(lambda: plain(args))
    b = bound(*work)
    log(f"kernel {name}: max_abs_err {err:.3e} (limit {tol * scale:.3e}), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e9:.3f}"
        f" GB, {b['ops'] / 1e9:.3f} Gop)")
    if not agrees:
        raise SystemExit(f"{name}: kernel disagrees with its twin")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=None)


def fused_rows(prob, dev, variants):
    """Phase 3, the fused path's kernels: cloud optics and the fused
    LW and SW steps; into ``variants`` the fused steps by band and with
    incident fluxes."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs)
    from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import (
        cloud_props, cloud_props_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (sw_fused,
                                                           sw_fused_plain)
    inp = prob.inputs
    ncol, nlay = inp.play.shape
    ncell, nlev = ncol * nlay, nlay + 1
    cld = prob.cld_lw
    cloud_args = (cld.lane_inputs(inp.lwp, inp.iwp, inp.rel, inp.dei)
                  + cld.tables())
    nbnd_c = cloud_args[3].shape[2]
    lw = allsky_lw_inputs(inp, prob.gas_lw, cloud_optics=prob.cld_lw)
    sw = allsky_sw_inputs(inp, prob.gas_sw, cloud_optics=prob.cld_sw)
    gpt = lambda x: sum(w for (_, _, _, w, _) in x.minors)
    ngl, ngs = lw.kmajor.shape[3], sw.kmajor.shape[3]
    ops_lw = ncell * (ngl * (8 * (OPS_MAJOR_CORNER + OPS_PFRAC_CORNER)
                             + OPS_PLANCK + OPS_LW_LAYER)
                      + gpt(lw) * OPS_MINOR)
    ops_sw = ncell * (ngs * (8 * OPS_MAJOR_CORNER + OPS_RAYLEIGH
                             + OPS_SW_COMBINE + OPS_SW_LAYER)
                      + gpt(sw) * OPS_MINOR)
    rows = [
        check_kernel("cloud_props", lambda a: cloud_props(*a),
                     lambda a: cloud_props_plain(*a), cloud_args, TOL_GATHER,
                     "rte_rrtmgp_tpu_torch/csrc/cloud_props.cu",
                     "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:227",
                     (nbytes(cloud_args) + 3 * nbnd_c * ncell * 4,
                      OPS_CLOUD * nbnd_c * ncell)),
        check_kernel("fused_lw", lw_fused, lw_fused_plain, lw, TOL_FLUX,
                     "rte_rrtmgp_tpu_torch/csrc/fused_lw.cu",
                     "rte_rrtmgp_tpu/ops/pallas/fused_lw.py:368",
                     (nbytes(tuple(lw)) + 2 * nlev * ncol * 4, ops_lw)),
        check_kernel("fused_sw", sw_fused, sw_fused_plain, sw, TOL_FLUX,
                     "rte_rrtmgp_tpu_torch/csrc/fused_sw.cu",
                     "rte_rrtmgp_tpu/ops/pallas/fused_sw.py:309",
                     (nbytes(tuple(sw)) + 3 * nlev * ncol * 4, ops_sw)),
    ]
    gen = torch.Generator(device=dev).manual_seed(3)
    inc = 3.0 * torch.rand(lw.inc.shape, generator=gen, device=dev)
    nbl, nbs = lw.totplnk.shape[1], sw.nband
    for name, kernel, plain, x, nout in (
            ("fused_lw byband", lw_fused, lw_fused_plain,
             lw._replace(byband=True), 2 * nbl),
            ("fused_sw byband", sw_fused, sw_fused_plain,
             sw._replace(byband=True), 3 * nbs),
            ("fused_lw inc", lw_fused, lw_fused_plain, lw._replace(inc=inc), 2),
            ("fused_sw incdif", sw_fused, sw_fused_plain,
             sw._replace(incdif=0.05 * sw.inc * inc[:sw.inc.shape[0]]), 3)):
        src = "fused_lw" if name.startswith("fused_lw") else "fused_sw"
        variants.append(check_kernel(
            name, kernel, plain, x, TOL_FLUX,
            f"rte_rrtmgp_tpu_torch/csrc/{src}.cu", rows[1 + (
                src == "fused_sw")]["replaces"],
            (nbytes(tuple(x)) + nout * nlev * ncol * 4,
             ops_lw if src == "fused_lw" else ops_sw)))
    return rows


def api_rows(prob, dev, variants):
    """Phase 3, the public-API path's kernels: the staged major, minor and
    Rayleigh gathers and the LW and SW solvers, on inputs prepared as the
    path prepares them; into ``variants`` the solvers by band."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import _split_minors
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (gas_major,
                                                            gas_major_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (
        gas_minor, gas_minor_plain, gas_rayleigh, gas_rayleigh_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import (lw_noscat,
                                                            lw_noscat_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import (sw_2stream,
                                                            sw_2stream_plain)
    from rte_rrtmgp_tpu_torch.optical_props import delta_scale, increment
    inp = prob.inputs
    ncol, nlay = inp.play.shape
    ncell = ncol * nlay
    gl, gs = prob.gas_lw, prob.gas_sw

    def cells(gas):
        col_gas, col_dry, idx_h2o = gas.col_gas(inp.play, inp.plev,
                                                inp.gas_concs)
        return gas.interp(inp.play, inp.tlay, col_gas), col_gas, col_dry, \
            idx_h2o

    co, col_gas, _, idx_h2o = cells(gl)
    kd = gl.kdist
    ngl = kd.ngpt
    major = (co, kd.kmajor, kd.planck_frac, gl.gpoint_flavor)
    rows = [check_kernel(
        "gas_major", lambda a: gas_major(*a), lambda a: gas_major_plain(*a),
        major, TOL_GATHER, "rte_rrtmgp_tpu_torch/csrc/gas_major.cu",
        "rte_rrtmgp_tpu/ops/pallas/major_gather.py:188",
        (nbytes(major) + 2 * ncell * ngl * 4,
         ncell * ngl * 8 * (OPS_MAJOR_CORNER + OPS_PFRAC_CORNER)))]

    tau = gas_major_plain(*major)[0]
    lo = _split_minors(gl.minors)[0]
    scaling = minor_scaling(co, kd.minor_lower, lower=True, play=inp.play,
                            tlay=inp.tlay, col_gas=col_gas, idx_h2o=idx_h2o)
    minor = (tau, co, kd.kminor_lower, lo, gl.minor_meta[:len(lo)], scaling)
    covered = sum(w for (_, _, w, _) in lo)
    rows.append(check_kernel(
        "gas_minor", lambda a: gas_minor(*a), lambda a: gas_minor_plain(*a),
        minor, TOL_GATHER, "rte_rrtmgp_tpu_torch/csrc/gas_minor.cu",
        "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:100",
        (nbytes(co.jtemp, co.ftemp, co.jeta, co.feta, kd.kminor_lower,
                scaling) + 2 * tau.numel() * 4,
         ncell * covered * OPS_MINOR),
        fresh=lambda a: (a[0].clone(),) + a[1:]))
    del minor, tau, scaling

    co, col_gas, col_dry, idx_h2o = cells(gs)
    kds = gs.kdist
    ngs = kds.ngpt
    tau = gas_major_plain(co, kds.kmajor, None, gs.gpoint_flavor)[0]
    rayl = (tau, co, kds.krayl, gs.gpoint_flavor,
            (col_gas[idx_h2o] + col_dry).contiguous(), True)
    rows.append(check_kernel(
        "gas_rayleigh", lambda a: gas_rayleigh(*a),
        lambda a: gas_rayleigh_plain(*a), rayl, TOL_GATHER,
        "rte_rrtmgp_tpu_torch/csrc/gas_minor.cu",
        "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:161",
        (nbytes(co.jtemp, co.ftemp, co.tropo, co.jeta, co.feta, kds.krayl,
                rayl[4]) + 3 * tau.numel() * 4,
         ncell * ngs * OPS_RAYLEIGH),
        fresh=lambda a: (a[0].clone(),) + a[1:]))
    del rayl, tau, co, col_gas, col_dry

    # LW solver with Tang rescaling, the Jacobian, an incident flux and
    # per-(column, g-point) secants, on the path's gas optics and sources
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    props, src = gl.gas_optics_lw(inp.play, inp.plev, inp.tlay, inp.tsfc,
                                  inp.gas_concs, tlev=inp.tlev, top_at_1=True)
    shape = tuple(props.tau.shape)
    bc = (ncol, ngl)
    lw = (props.tau, src.lay_source, src.lev_source, rand(bc, 0.8, 1.0),
          src.sfc_source, rand(bc, 0.0, 2.0),
          dict(ds=gl.compute_optimal_angles(props), weight=1.0,
               sfc_src_jac=src.sfc_source_jac, ssa=rand(shape, 0.0, 0.6),
               g=rand(shape, 0.0, 0.9)))
    call = lambda f: lambda a: f(*a[:6], **a[6])
    rows.append(check_kernel(
        "solver_lw", call(lw_noscat), call(lw_noscat_plain), lw, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/solver_lw.cu",
        "rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py:239",
        (nbytes(lw) + 3 * ncol * (nlay + 1) * 4,
         ncol * nlay * ngl * (OPS_LW_LAYER + OPS_LW_RESCALE))))
    nbl = gl.grid.nband
    lwb = lw[:6] + (dict(lw[6], gpt2band=gl.gpt2band, nband=nbl),)
    variants.append(check_kernel(
        "solver_lw byband", call(lw_noscat), call(lw_noscat_plain), lwb,
        TOL_FLUX, rows[-1]["source"], rows[-1]["replaces"],
        (nbytes(lwb) + (2 * nbl + 1) * ncol * (nlay + 1) * 4,
         ncol * nlay * ngl * (OPS_LW_LAYER + OPS_LW_RESCALE))))
    del lw, lwb, props, src

    # SW solver with a diffuse incident flux, night columns and mu0 that
    # varies by layer, on the path's gas optics and delta-scaled clouds
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
    bc = (ncol, ngs)
    inc = toa.contiguous()
    sw = (props.tau, props.ssa, props.g, mu0, rand(bc, 0.0, 0.3),
          rand(bc, 0.0, 0.3), inc, 0.05 * inc)
    rows.append(check_kernel(
        "solver_sw", lambda a: sw_2stream(*a), lambda a: sw_2stream_plain(*a),
        sw, TOL_FLUX, "rte_rrtmgp_tpu_torch/csrc/solver_sw.cu",
        "rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py:222",
        (nbytes(sw) + 3 * ncol * (nlay + 1) * 4,
         ncol * nlay * ngs * OPS_SW_LAYER)))
    nbs = gs.grid.nband
    swb = sw + (gs.gpt2band,)
    variants.append(check_kernel(
        "solver_sw byband", lambda a: sw_2stream(*a, nband=nbs),
        lambda a: sw_2stream_plain(*a, nband=nbs), swb, TOL_FLUX,
        rows[-1]["source"], rows[-1]["replaces"],
        (nbytes(swb) + 3 * nbs * ncol * (nlay + 1) * 4,
         ncol * nlay * ngs * OPS_SW_LAYER)))
    return rows


def lw2_step(prob, byband=False):
    """The LW two-stream path, reference check_variants' true two-stream
    with clouds (examples/flux_variants.py:76-82): gas optics with
    scattering, the 2-stream cloud optics, increment, then
    rte_lw(use_2stream=True). Returns step(inputs) -> (flux_up, flux_dn),
    (ncol, nlay+1) or by band (ncol, nlay+1, nband)."""
    from rte_rrtmgp_tpu_torch.optical_props import increment
    from rte_rrtmgp_tpu_torch.rte import rte_lw

    def step(i):
        props, src = prob.gas_lw.gas_optics_lw(
            i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
            scattering=True, top_at_1=True)
        props = increment(props, prob.cld_lw.cloud_optics(
            i.lwp, i.iwp, i.rel, i.dei, scattering=True))
        f = rte_lw(props, src, i.sfc_emis, use_2stream=True, byband=byband)
        return f.flux_up, f.flux_dn
    return step


def lw2_rows(prob, dev, variants):
    """Phase 3, the LW two-stream kernel on the two-stream path's inputs
    (what rte_lw hands it: no incident flux); into ``variants`` the same
    by band. The layer source is in its signature but never read, so its
    bytes are not counted."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (
        lw_2stream, lw_2stream_plain)
    from rte_rrtmgp_tpu_torch.optical_props import increment
    i = prob.inputs
    props, src = prob.gas_lw.gas_optics_lw(
        i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
        scattering=True, top_at_1=True)
    props = increment(props, prob.cld_lw.cloud_optics(
        i.lwp, i.iwp, i.rel, i.dei, scattering=True))
    ncol, nlay, ngpt = props.tau.shape
    emis = i.sfc_emis.expand(ncol, ngpt).contiguous()
    args = (props.tau.contiguous(), props.ssa.contiguous(),
            props.g.contiguous(), src.lay_source, src.lev_source, emis,
            src.sfc_source, torch.zeros_like(emis))
    del props, src
    ops = ncol * nlay * ngpt * OPS_LW2_LAYER
    where = ("rte_rrtmgp_tpu_torch/csrc/solver_lw_2str.cu",
             "rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py:411")
    row = check_kernel("solver_lw_2str", lambda a: lw_2stream(*a),
                       lambda a: lw_2stream_plain(*a), args, TOL_FLUX, *where,
                       (nbytes(args[:3], args[4:]) + 2 * ncol * (nlay + 1) * 4,
                        ops), ill_conditioned=True)
    nb = prob.gas_lw.grid.nband
    argb = args + (prob.gas_lw.gpt2band,)
    variants.append(check_kernel(
        "solver_lw_2str byband", lambda a: lw_2stream(*a, nband=nb),
        lambda a: lw_2stream_plain(*a, nband=nb), argb, TOL_FLUX, *where,
        (nbytes(argb[:3], argb[4:]) + 2 * nb * ncol * (nlay + 1) * 4, ops),
        ill_conditioned=True))
    return [row]


def lanes_rows(prob, nonbanded):
    """Phase 3, the staged path's lane solvers on inputs prepared as the
    path prepares them, clouds and aerosols on: the solvers that form
    their own sources or combine (rows 11, 13) on the flagship problem,
    the plain ones (rows 10, 12) on the non-banded configuration."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (_absorption_lanes,
                                                     _scattering_lanes)
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lanes as sl
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS
    call = lambda f: lambda a: f(*a[:-1], **a[-1])
    angle = dict(ds=GAUSS_DS[0][0], weight=GAUSS_WTS[0][0])
    rows = []

    def lw_args(p, banded):
        inp = p.inputs
        out = p.gas_lw.gas_optics_lw_lanes(
            inp.play, inp.plev, inp.tlay, inp.tsfc, inp.gas_concs,
            tlev=inp.tlev, banded_planck=banded)
        cld = _absorption_lanes(inp, p.cld_lw, True, p.aer_lw, True)
        tau = out[0]
        ngpt, _, ncol = tau.shape
        emis = inp.sfc_emis[:, 0][None, :].expand(ngpt, ncol)
        inc = tau.new_zeros(()).expand(ngpt, ncol)
        if banded:
            _, pfrac, (pbs, pbl, pbv) = out
            return (tau, pfrac, pbl, pbv, pbs, emis, inc,
                    dict(angle, gpt2band=p.gas_lw.gpt2band,
                         cloud_tau_abs=cld))
        sfc, lay, lev, _ = out[1]
        tau = tau + cld[p.gas_lw.gpt2band.long()]
        return (tau, lay, lev, emis, sfc, inc, dict(angle))

    def sw_args(p, banded):
        inp = p.inputs
        tau, second, toa = p.gas_sw.gas_optics_sw_lanes(
            inp.play, inp.plev, inp.tlay, inp.gas_concs,
            split_rayleigh=banded)
        cloud = _scattering_lanes(inp, p.cld_sw, True, p.aer_sw, True)
        ngpt, nlay, ncol = tau.shape
        mu0 = inp.mu0[None, :].expand(nlay, ncol)
        alb = inp.sfc_alb[:, 0][None, :].expand(ngpt, ncol)
        if banded:
            return (tau, second, cloud, mu0, alb, alb, toa, None,
                    dict(gpt2band=p.gas_sw.gpt2band))
        tau, ssa, g = sl.increment_2str_bybnd(tau, second, cloud,
                                              p.gas_sw.gpt2band,
                                              torch.finfo(tau.dtype).tiny)
        return (tau, ssa, g, mu0, alb, alb, toa, None, {})

    src_lw = "rte_rrtmgp_tpu_torch/csrc/solver_lw.cu"
    src_sw = "rte_rrtmgp_tpu_torch/csrc/solver_sw.cu"
    lanes = "rte_rrtmgp_tpu/ops/pallas/solver_lanes.py"
    for name, p, banded, kernel, plain, src, line, ops in (
            ("solver_lw_lanes", nonbanded, False, sl.lw_noscat_lanes,
             sl.lw_noscat_lanes_plain, src_lw, 224, OPS_LW_LAYER),
            ("solver_lw_pfrac", prob, True, sl.lw_noscat_lanes_pfrac,
             sl.lw_noscat_lanes_pfrac_plain, src_lw, 372,
             OPS_LW_LAYER + OPS_PFRAC_SOURCES),
            ("solver_sw_lanes", nonbanded, False, sl.sw_2stream_lanes,
             sl.sw_2stream_lanes_plain, src_sw, 675, OPS_SW_LAYER),
            ("solver_sw_combined", prob, True,
             sl.sw_2stream_lanes_combined,
             sl.sw_2stream_lanes_combined_plain, src_sw, 774,
             OPS_SW_LAYER + OPS_SW_COMBINE)):
        sw = name.startswith("solver_sw")
        args = (sw_args if sw else lw_args)(p, banded)
        ngpt, nlay, ncol = args[0].shape
        nout = (3 if sw else 2) * (nlay + 1) * ncol * 4
        rows.append(check_kernel(
            name, call(kernel), call(plain), args, TOL_FLUX, src,
            f"{lanes}:{line}", (nbytes(args) + nout, ncol * nlay * ngpt * ops)))
        del args
    return rows


def subset_inputs(inputs, n):
    """The all-sky inputs of the first n columns."""
    from rte_rrtmgp_tpu_torch.gas_concs import GasConcs
    gc = inputs.gas_concs
    gc = GasConcs(names=gc.names, values=tuple(
        v[:n] if v.ndim == 2 else v for v in gc.values))
    return inputs._replace(**{k: getattr(inputs, k)[:n]
                              for k in inputs._fields if k != "gas_concs"},
                           gas_concs=gc)


def to_f64(tree):
    """``tree`` (tensors in nested tuples and NamedTuples) with every
    float tensor in float64."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_f64(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(to_f64(v) for v in tree)
    return tree


@contextlib.contextmanager
def float32_constants():
    """``torch.finfo`` of any dtype gives float32's within the block: the
    twins' eps- and tiny-based clamps and guards (min_k, min_mu0, the
    small-tau threshold) take the float32 values the kernels use, so a
    float64 twin is the float32 algorithm in float64 arithmetic."""
    import torch
    finfo = torch.finfo
    torch.finfo = lambda dtype=None: finfo(torch.float32)
    try:
        yield
    finally:
        torch.finfo = finfo


def check_adjoint(name, kernel, plain, make, source, replaces, ops_per_col):
    """An adjoint kernel against its plain version (the twin's autograd)
    on the same inputs and seeded cotangents, ``make(n)`` building them
    for n columns: compared at 4096 columns, or at the largest halving
    whose twin graph fits in memory (printed); each cotangent within
    TOL_ADJ of its largest twin value, or, where the float32 twin is
    itself further than that from the float64 twin (run on the card with
    the float32 constants), within TOL_ADJ of the float64 twin's.
    The kernel is timed at 4096."""
    import torch
    ncol = MAIN["ncol"]
    n = ncol
    while True:
        args = make(n)
        try:
            ref = as_tuple(plain(args))
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            del args
            torch.cuda.empty_cache()
            n //= 2
            if n < 64:
                raise SystemExit(f"{name}: the twin does not fit at 64 "
                                 "columns")
    got = as_tuple(kernel(args))
    torch.cuda.synchronize()
    if len(got) != len(ref):
        raise SystemExit(f"{name}: kernel gives {len(got)} cotangents, twin "
                         f"{len(ref)}")
    errs, beyond = [], []
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{name}: cotangent {i} {tuple(g.shape)} is not "
                             f"finite or not {tuple(r.shape)}")
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        errs.append(err)
        log(f"kernel {name}: cotangent {i} {tuple(r.shape)} max_abs_err "
            f"{err:.3e} (limit {TOL_ADJ * scale:.3e})")
        if not err <= TOL_ADJ * scale:
            beyond.append(i)
    if beyond:
        with float32_constants():
            ref64 = as_tuple(plain(to_f64(args)))
        for i in beyond:
            scale = float(ref64[i].abs().max())
            k64 = float((got[i].double() - ref64[i]).abs().max()) / scale
            t64 = float((ref[i].double() - ref64[i]).abs().max()) / scale
            log(f"kernel {name}: cotangent {i} against the float64 twin: "
                f"kernel {k64:.3e}, float32 twin {t64:.3e} of its largest "
                f"value (limit {TOL_ADJ} for the kernel, where the float32 "
                f"twin is beyond it)")
            if not (t64 > TOL_ADJ and k64 <= TOL_ADJ):
                raise SystemExit(f"{name}: cotangent {i} disagrees with the "
                                 "twin")
        del ref64
    plain_ms = cuda_ms(lambda: plain(args), reps=3)
    del got, ref, args
    torch.cuda.empty_cache()
    args = make(ncol)
    ms = cuda_ms(lambda: kernel(args))
    b = bound(nbytes(args) + nbytes(as_tuple(kernel(args))),
              ops_per_col * ncol)
    log(f"kernel {name}: compared at {n} columns, kernel {ms:.3f} ms at "
        f"{ncol}, plain {plain_ms:.3f} ms at {n}, bound {b['bound_ms']:.4f}"
        f" ms by {b['bound_by']} ({b['bytes'] / 1e9:.3f} GB, "
        f"{b['ops'] / 1e9:.3f} Gop)")
    del args
    torch.cuda.empty_cache()
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=None)


def adjoint_rows(prob, dev, variants):
    """Phase 3, the backward kernels, on the inputs their paths give them
    (clouds on) and seeded cotangents of the broadband fluxes: the fused
    adjoints on the fused step's inputs, the solver adjoints on the public
    path's optics and sources; into ``variants`` the fused adjoints with
    an incident flux (LW) and a diffuse incident flux (SW)."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs)
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw as flw
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_sw as fsw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_bwd as slw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw_bwd as ssw
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS
    from rte_rrtmgp_tpu_torch.optical_props import delta_scale, increment
    nlay = MAIN["nlay"]
    gl, gs = prob.gas_lw, prob.gas_sw

    def cot(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return 0.5 + torch.rand(shape, generator=gen, device=dev)

    def fused_lw_args(n):
        inp = subset_inputs(prob.inputs, n)
        return (allsky_lw_inputs(inp, gl, cloud_optics=prob.cld_lw),
                cot((nlay + 1, n), 1), cot((nlay + 1, n), 2))

    def fused_sw_args(n):
        inp = subset_inputs(prob.inputs, n)
        return (allsky_sw_inputs(inp, gs, cloud_optics=prob.cld_sw),
                cot((nlay + 1, n), 3), cot((nlay + 1, n), 4),
                cot((nlay + 1, n), 5))

    def lw_args(n):
        i = subset_inputs(prob.inputs, n)
        props, src = gl.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                      i.gas_concs, tlev=i.tlev, top_at_1=True)
        props = increment(props, prob.cld_lw.cloud_optics(
            i.lwp, i.iwp, i.rel, i.dei, scattering=False))
        ngpt = props.tau.shape[2]
        emis = i.sfc_emis.expand(n, ngpt).contiguous()
        return (props.tau.contiguous(), src.lay_source, src.lev_source, emis,
                src.sfc_source, torch.zeros_like(emis),
                cot((n, nlay + 1), 6), cot((n, nlay + 1), 7))

    def sw_args(n):
        i = subset_inputs(prob.inputs, n)
        props, toa = gs.gas_optics_sw(i.play, i.plev, i.tlay, i.gas_concs,
                                      top_at_1=True)
        props = increment(props, delta_scale(prob.cld_sw.cloud_optics(
            i.lwp, i.iwp, i.rel, i.dei)))
        ngpt = props.tau.shape[2]
        alb = i.sfc_alb.expand(n, ngpt).contiguous()
        inc = toa.contiguous()
        return (props.tau, props.ssa, props.g,
                i.mu0[:, None].expand(n, nlay).contiguous(), alb, alb, inc,
                torch.zeros_like(inc), cot((n, nlay + 1), 8),
                cot((n, nlay + 1), 9), cot((n, nlay + 1), 10))

    gpt = lambda g: sum(w for (_, _, _, w, _) in g.minors)
    ngl, ngs = gl.ngpt, gs.ngpt
    ops_flw = nlay * (ngl * (8 * (OPS_MAJOR_CORNER + OPS_PFRAC_CORNER
                                  + OPS_MAJOR_ADJ_CORNER) + OPS_PLANCK
                             + OPS_LW_ADJ)
                      + gpt(gl) * (OPS_MINOR + OPS_MINOR_ADJ))
    ops_fsw = nlay * (ngs * (8 * (OPS_MAJOR_CORNER + OPS_MAJOR_ADJ_CORNER)
                             + OPS_RAYLEIGH + OPS_RAYLEIGH_ADJ
                             + OPS_SW_COMBINE + OPS_COMBINE_ADJ + OPS_SW_ADJ)
                      + gpt(gs) * (OPS_MINOR + OPS_MINOR_ADJ))
    ds, wt = GAUSS_DS[0][0], 1.0
    pallas = "rte_rrtmgp_tpu/ops/pallas"
    csrc = "rte_rrtmgp_tpu_torch/csrc"

    def fused_lw_inc_args(n):
        x, gu, gd = fused_lw_args(n)
        return x._replace(inc=3.0 * cot(x.inc.shape, 11)), gu, gd

    def fused_sw_incdif_args(n):
        x, *gs_ = fused_sw_args(n)
        return (x._replace(incdif=0.05 * x.inc * cot(x.inc.shape, 12)),
                *gs_)

    variants += [
        check_adjoint("fused_lw_bwd inc", lambda a: flw.lw_fused_bwd(*a),
                      lambda a: flw.lw_fused_bwd_plain(*a),
                      fused_lw_inc_args, f"{csrc}/fused_lw_bwd.cu",
                      f"{pallas}/fused_lw_bwd.py:506", ops_flw),
        check_adjoint("fused_sw_bwd incdif", lambda a: fsw.sw_fused_bwd(*a),
                      lambda a: fsw.sw_fused_bwd_plain(*a),
                      fused_sw_incdif_args, f"{csrc}/fused_sw_bwd.cu",
                      f"{pallas}/fused_sw_bwd.py:694", ops_fsw)]
    return [
        check_adjoint("fused_lw_bwd", lambda a: flw.lw_fused_bwd(*a),
                      lambda a: flw.lw_fused_bwd_plain(*a), fused_lw_args,
                      f"{csrc}/fused_lw_bwd.cu", f"{pallas}/fused_lw_bwd.py:506",
                      ops_flw),
        check_adjoint("fused_sw_bwd", lambda a: fsw.sw_fused_bwd(*a),
                      lambda a: fsw.sw_fused_bwd_plain(*a), fused_sw_args,
                      f"{csrc}/fused_sw_bwd.cu", f"{pallas}/fused_sw_bwd.py:694",
                      ops_fsw),
        check_adjoint("solver_lw_bwd",
                      lambda a: slw.lw_noscat_bwd(*a, ds=ds, weight=wt),
                      lambda a: slw.lw_noscat_bwd_plain(*a, ds=ds, weight=wt),
                      lw_args, f"{csrc}/solver_lw_bwd.cu",
                      f"{pallas}/solver_lw_bwd.py:207", nlay * ngl * OPS_LW_ADJ),
        check_adjoint("solver_sw_bwd", lambda a: ssw.sw_2stream_bwd(*a),
                      lambda a: ssw.sw_2stream_bwd_plain(*a), sw_args,
                      f"{csrc}/solver_sw_bwd.cu",
                      f"{pallas}/solver_sw_bwd.py:402", nlay * ngs * OPS_SW_ADJ),
    ]


def adjoint_report(prob, reports):
    """Phase 3, the adjoint kernels' resources at the main path's shapes:
    ptxas registers and spills of each instantiation, resident blocks per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, from the kernels'
    own libraries) and the device scratch of one launch."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs)
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw as flw
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_sw as fsw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_bwd as slw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw_bwd as ssw
    from rte_rrtmgp_tpu_torch.ops.kernels._build import ptxas_usage
    inp = prob.inputs
    ncol, nlay = inp.play.shape
    ngl, ngs = prob.gas_lw.ngpt, prob.gas_sw.ngpt
    xl = allsky_lw_inputs(inp, prob.gas_lw, cloud_optics=prob.cld_lw)
    xs = allsky_sw_inputs(inp, prob.gas_sw, cloud_optics=prob.cld_sw)
    for name, blocks, scratch in (
            ("fused_lw_bwd", flw.lw_fused_bwd_occupancy(xl),
             flw.lw_fused_bwd_scratch_bytes(ncol, nlay, ngl)),
            ("fused_sw_bwd", fsw.sw_fused_bwd_occupancy(xs),
             fsw.sw_fused_bwd_scratch_bytes(ncol, nlay, ngs)),
            ("solver_lw_bwd", slw.lw_noscat_bwd_occupancy(ngl), 0),
            ("solver_sw_bwd", ssw.sw_2stream_bwd_occupancy(ngs, nlay),
             ssw.sw_2stream_bwd_scratch_bytes(ncol, nlay, ngs))):
        rep = reports.get(name)
        regs = ("not rebuilt in this run" if rep is None else ", ".join(
            f"{r} registers, {ss} B spill stores, {sl} B spill loads"
            for r, ss, sl in ptxas_usage(rep)))
        log(f"adjoint {name}: ptxas {regs}; {blocks} resident blocks per SM"
            f" at {ncol} x {nlay}; scratch {scratch} B "
            f"({scratch / 1e9:.3f} GB)")
        if blocks < 1:
            raise SystemExit(f"{name}: no block fits an SM ({blocks})")
    del xl, xs


def train_loss(step, inputs):
    """One training step's loss and its gradients with respect to (tlay,
    tsfc, lwp, rel, h2o vmr): sum(w_lev up) + 0.5 sum(w_lev dn) for LW and
    SW, + 0.25 sum(SW direct), w_lev = linspace(0.5, 1.5, nlay+1) (as
    tests/test_fused_autodiff.py:69)."""
    import torch
    ncol, nlay = inputs.play.shape
    leaves = {k: getattr(inputs, k).detach().clone().requires_grad_()
              for k in ("tlay", "tsfc", "lwp", "rel")}
    leaves["h2o"] = inputs.gas_concs.get_vmr("h2o", ncol, nlay).detach() \
        .clone().requires_grad_()
    gc = inputs.gas_concs.set_vmr("h2o", leaves["h2o"])
    inp = inputs._replace(gas_concs=gc, **{k: v for k, v in leaves.items()
                                           if k != "h2o"})
    lw_up, lw_dn, sw_up, sw_dn, sw_dir = step(inp)
    w = torch.linspace(0.5, 1.5, nlay + 1, dtype=lw_up.dtype,
                       device=lw_up.device)[None, :]
    loss = ((w * lw_up).sum() + 0.5 * (w * lw_dn).sum() + (w * sw_up).sum()
            + 0.5 * (w * sw_dn).sum() + 0.25 * sw_dir.sum())
    grads = torch.autograd.grad(loss, tuple(leaves.values()))
    return loss, dict(zip(leaves, grads))


def gradient_gates(dev):
    """Phase 4, the gradients at the production configuration (256 x 72):
    the float32 fused-path d(sum of TOA LW up)/d(tsfc) against the
    analytic surface Jacobian transported by lw_solver_noscat (rtol 2e-2,
    all positive; tests/test_fused_autodiff.py:110-149), then the float32
    card gradients of the training loss against the port's float64 twin
    on the CPU: the largest difference per input over that input's
    largest float64 gradient, printed as the measured noise floor (no
    gate)."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_step_lw,
                                                     build_allsky,
                                                     build_allsky_step)
    from rte_rrtmgp_tpu_torch.ops.solver_lw import (GAUSS_DS, GAUSS_WTS,
                                                    lw_solver_noscat)
    from rte_rrtmgp_tpu_torch.optical_props import increment
    p = build_allsky(**PROD, device=dev)
    i = p.inputs
    tsfc = i.tsfc.clone().requires_grad_()
    f = allsky_step_lw(i._replace(tsfc=tsfc), p.gas_lw, cloud_optics=p.cld_lw)
    grad, = torch.autograd.grad(f.flux_up[:, 0].sum(), tsfc)
    props, src = p.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                        i.gas_concs, tlev=i.tlev,
                                        top_at_1=True)
    props = increment(props, p.cld_lw.cloud_optics(i.lwp, i.iwp, i.rel,
                                                   i.dei, scattering=False))
    ngpt = props.tau.shape[2]
    emis = i.sfc_emis.expand(-1, ngpt).contiguous()
    jac = lw_solver_noscat(props.tau, src.lay_source, src.lev_source, emis,
                           src.sfc_source, torch.zeros_like(emis),
                           top_at_1=True, ds=GAUSS_DS[0],
                           weights=GAUSS_WTS[0],
                           sfc_src_jac=src.sfc_source_jac,
                           do_jacobians=True).flux_up_jac[:, 0]
    rel = float(((grad - jac).abs() / jac.abs()).max())
    log(f"gradient gate: fused d(TOA up)/d(tsfc) vs analytic Jacobian, max "
        f"rel diff {rel:.3e} (limit 2e-2), Jacobian min "
        f"{float(jac.min()):.4g} W/m2/K")
    if not (rel <= 2e-2 and bool((jac > 0).all())):
        raise SystemExit("the fused tsfc gradient disagrees with the "
                         "analytic surface Jacobian")
    step, inputs = build_allsky_step(**PROD, device=dev)
    _, g32 = train_loss(step, inputs)
    t0 = time.perf_counter()
    step64, inputs64 = build_allsky_step(**PROD, device="cpu",
                                         dtype=torch.float64)
    _, g64 = train_loss(step64, inputs64)
    log(f"gradient noise floor: float64 twin gradients on the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    for k, v in g64.items():
        d = float((g32[k].double().cpu() - v).abs().max())
        log(f"gradient noise floor {k}: max |f32 card - f64 twin| / max "
            f"|f64| = {d / float(v.abs().max()):.3e}")


def training_steps(name, step, inputs, counters, exact, launched):
    """Phase 5: two training steps (forward + backward) of one path with
    the counters set to 0 just before them: the kernels a step launches an
    exact number of times (``exact``, name -> launches per step), those it
    launches at least once (``launched``), no other; finite gradients that
    are not all zero and bit-identical over the two steps; then the median
    step time beside the forward's. Returns the launches of one step."""
    import torch
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    runs = [train_loss(step, inputs) for _ in range(2)]
    torch.cuda.synchronize()
    launches = {k: fn.launches // 2 for k, fn in counters.items()}
    log(f"{name} training step launches: {launches}")
    for k, n in launches.items():
        if k in exact and n != exact[k]:
            raise SystemExit(f"{name} training step launched {k} {n} times,"
                             f" expected {exact[k]}")
        if k in launched and n == 0:
            raise SystemExit(f"{name} training step never launched {k}")
        if k not in exact and k not in launched and n != 0:
            raise SystemExit(f"{name} training step launched {k}")
    (_, ga), (_, gb) = runs
    for k in ga:
        if not bool(torch.isfinite(ga[k]).all()) or not bool(
                (ga[k] != 0).any()):
            raise SystemExit(f"{name}: d loss / d {k} not finite or all "
                             "zero")
        if not torch.equal(ga[k], gb[k]):
            raise SystemExit(f"{name}: d loss / d {k} differs between two "
                             "runs")
    log(f"{name} training step: gradients finite and bit-identical over "
        "two runs; max |d loss / d x|: " + ", ".join(
            f"{k} {float(v.abs().max()):.3e}" for k, v in ga.items()))
    times = {}
    for what, fn in (("forward+backward", lambda: train_loss(step, inputs)),
                     ("forward", lambda: step(inputs))):
        ts = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[what] = statistics.median(ts) * 1e3
    log(f"{name} training step: {times['forward+backward']:.3f} ms median "
        f"of {REPS} (forward alone {times['forward']:.3f} ms)")
    return launches


def golden_gate(what, out, golden=None):
    """Each float32 field within 3x the float32 noise floor of the f64
    golden (the production configuration): tests/golden/production.npz,
    or the given float64 fields."""
    import numpy as np
    if golden is None:
        golden = np.load(os.path.join(HERE, "tests", "golden",
                                      "production.npz"))
    with open(os.path.join(HERE, "tests", "golden",
                           "production_f32_noise.json")) as f:
        noise = json.load(f)["f32_noise"]
    for key, o in zip(("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir"), out):
        d = float(np.abs(o.double().cpu().numpy()
                         - np.asarray(golden[key])).max())
        log(f"golden {what} {key}: max |f32 - f64 golden| {d:.4g} "
            f"(limit {3 * noise[key]:.4g})")
        if not d <= 3 * noise[key]:
            raise SystemExit(f"golden gate failed on {what} {key}")


def step_fn(prob, path, **opts):
    """One all-sky step through the public API ("api") or the staged
    lane-layout branch ("staged"), composed from the problem's objects:
    (lw_up, lw_dn, sw_up, sw_dn, sw_dn_dir), each (ncol, nlay+1)."""
    from rte_rrtmgp_tpu_torch.drivers import allsky
    lw_fn = getattr(allsky, f"allsky_{path}_lw")
    sw_fn = getattr(allsky, f"allsky_{path}_sw")

    def step(inputs):
        lw = lw_fn(inputs, prob.gas_lw, cloud_optics=prob.cld_lw,
                   aerosol_optics=prob.aer_lw, **opts)
        sw = sw_fn(inputs, prob.gas_sw, cloud_optics=prob.cld_sw,
                   aerosol_optics=prob.aer_sw, **opts)
        return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                sw.flux_dn_dir)
    return step


def agree(what, out, ref):
    """A path's fluxes against a reference path's (the fused path, or the
    broadband run of a by-band one) on the same inputs."""
    gap = max(float(((a - f).abs() - PATH_RTOL * f.abs()).max())
              for a, f in zip(out, ref))
    diff = max(float((a - f).abs().max()) for a, f in zip(out, ref))
    log(f"{what} vs reference: max |diff| {diff:.3e} W/m2, max(|diff| - "
        f"{PATH_RTOL} |reference|) {gap:.3e} W/m2 (limit {PATH_ATOL})")
    if not gap <= PATH_ATOL:
        raise SystemExit(f"{what} and its reference disagree")


def run_path(name, step, inputs, counters, must, must_not, solar,
             once=(), nonneg=True):
    """Drive one path with the counters set to 0 just before it; check
    the launches (those in ``once`` exactly one), finite (and with
    ``nonneg`` non-negative) outputs and, with ``solar``, TOA SW; time it.
    Returns (outputs, launches)."""
    import torch
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = step(inputs)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"{name} path launches: {launches}")
    for k in must:
        if launches[k] == 0:
            raise SystemExit(f"{name} path never launched {k}")
    for k in must_not:
        if launches[k] != 0:
            raise SystemExit(f"{name} path launched {k}")
    for k in once:
        if launches[k] != 1:
            raise SystemExit(f"{name} path launched {k} {launches[k]} "
                             "times, expected once")
    ncol, nlev = inputs.play.shape[0], inputs.play.shape[1] + 1
    for o in out:
        if tuple(o.shape[:2]) != (ncol, nlev):
            raise SystemExit(f"{name} output shape {tuple(o.shape)}")
        if not bool(torch.isfinite(o).all()) or (nonneg
                                                 and bool((o < 0).any())):
            raise SystemExit(f"{name} path output not finite or negative")
    if not nonneg:
        log(f"{name}: smallest output {min(float(o.min()) for o in out):.4g}"
            " W/m2")
    if solar is not None:
        toa = solar * inputs.mu0.double()
        toa_err = float(((out[3][:, 0].double() - toa).abs() / toa).max())
        log(f"{name} sw_dn at TOA vs sum(solar source) * mu0: rel err "
            f"{toa_err:.2e}")
        if toa_err > 1e-5:
            raise SystemExit(f"{name}: sw_dn at TOA does not equal the "
                             "incident flux")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_step = statistics.median(times)
    log(f"{name} path step: {t_step * 1e3:.3f} ms median of {REPS}, "
        f"{ncol / t_step:.1f} columns/s")
    return out, launches


def profile_path(name, step, inputs, n=3, top=8):
    """Device time by kernel and the device's busy share over n steps,
    from torch.profiler (the profiler's own overhead lengthens the wall
    time, so the busy share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step(inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3 / n
    on_card = lambda e: e.device_type == torch.autograd.DeviceType.CUDA
    rows = sorted(((dev(e), e.count / n, e.key) for e in prof.key_averages()
                   if on_card(e) and dev(e) > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        log(f"profile {name}: the profiler saw no device time (not "
            "measured)")
        return
    log(f"profile {name}: device {total:.3f} ms per step, wall "
        f"{wall_ms:.3f} ms under the profiler, busy share "
        f"{total / wall_ms:.3f}")
    for ms, count, key in rows[:top]:
        log(f"profile {name}:   {ms:8.3f} ms  x{count:g}  {key[:70]}")
    rest = rows[top:]
    log(f"profile {name}:   {sum(r[0] for r in rest):8.3f} ms  in "
        f"{sum(r[1] for r in rest):g} other launches")


def angles_check(prob, inputs):
    """Phase 6: rte_lw with 3 Gauss angles and with per-(column, g-point)
    optimal-angle secants, on the card against the same calls on the CPU
    (the twins), on 512 columns."""
    import dataclasses
    from rte_rrtmgp_tpu_torch.rte import rte_lw
    from rte_rrtmgp_tpu_torch.optical_props import subset
    from rte_rrtmgp_tpu_torch.sources import subset_sources
    n = 512
    props, src = prob.gas_lw.gas_optics_lw(
        inputs.play, inputs.plev, inputs.tlay, inputs.tsfc,
        inputs.gas_concs, tlev=inputs.tlev, top_at_1=True)
    props, src = subset(props, 0, n), subset_sources(src, 0, n)
    emis = inputs.sfc_emis[:n]
    cpu = lambda x: x.cpu() if hasattr(x, "cpu") else x
    props_c = dataclasses.replace(props, tau=props.tau.cpu())
    src_c = dataclasses.replace(src, **{f: cpu(getattr(src, f)) for f in (
        "lay_source", "lev_source", "sfc_source", "sfc_source_jac")})
    ds = prob.gas_lw.compute_optimal_angles(props)
    for what, kw, kw_c in (("3 angles", dict(n_gauss_angles=3),
                            dict(n_gauss_angles=3)),
                           ("optimal angles", dict(lw_ds=ds),
                            dict(lw_ds=ds.cpu()))):
        got = rte_lw(props, src, emis, **kw)
        ref = rte_lw(props_c, src_c, emis.cpu(), **kw_c)
        pairs = ((got.flux_up, ref.flux_up), (got.flux_dn, ref.flux_dn))
        err = max(float((g.cpu() - r).abs().max()) for g, r in pairs)
        scale = max(float(r.abs().max()) for _, r in pairs)
        log(f"rte_lw {what}: card vs CPU twin max_abs_err {err:.3e} "
            f"(limit {TOL_FLUX * scale:.3e})")
        if not err <= TOL_FLUX * scale:
            raise SystemExit(f"rte_lw {what}: card and twin disagree")


def secant_check(prob, inputs):
    """Phase 6: lw_solver_noscat's secant as a tuple of floats, a 0-d
    tensor, a 1-D tensor and a tuple holding a 0-d tensor, at 4096
    columns: one kernel launch each and bit-identical fluxes."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import lw_noscat
    from rte_rrtmgp_tpu_torch.ops.solver_lw import lw_solver_noscat
    i = inputs
    props, src = prob.gas_lw.gas_optics_lw(i.play, i.plev, i.tlay, i.tsfc,
                                           i.gas_concs, tlev=i.tlev,
                                           top_at_1=True)
    emis = i.sfc_emis.expand(-1, props.tau.shape[2]).contiguous()
    args = (props.tau, src.lay_source, src.lev_source, emis, src.sfc_source,
            torch.zeros_like(emis))
    d = torch.tensor(1.66, device=emis.device)
    ref = None
    for what, ds in (("tuple", (1.66,)), ("0-d tensor", d),
                     ("1-D tensor", d[None]), ("tuple of a 0-d tensor", (d,))):
        n0 = lw_noscat.launches
        f = lw_solver_noscat(*args, top_at_1=True, ds=ds, weights=(0.5,))
        torch.cuda.synchronize()
        if lw_noscat.launches != n0 + 1:
            raise SystemExit(f"secant as a {what}: {lw_noscat.launches - n0}"
                             " launches of solver_lw, expected one")
        if ref is None:
            ref = f
            continue
        same = (torch.equal(f.flux_up, ref.flux_up)
                and torch.equal(f.flux_dn, ref.flux_dn))
        log(f"secant as a {what}: fluxes "
            f"{'bit-identical to' if same else 'differ from'} a tuple's")
        if not same:
            raise SystemExit(f"secant as a {what} gives other fluxes")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from rte_rrtmgp_tpu_torch.drivers.allsky import (build_allsky,
                                                     build_allsky_step)
    from rte_rrtmgp_tpu_torch.ops.kernels import _build
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lanes as sl
    from rte_rrtmgp_tpu_torch.ops.kernels.cloud_props import cloud_props
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_bwd)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (sw_fused,
                                                           sw_fused_bwd)
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (gas_minor,
                                                            gas_rayleigh)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import lw_noscat
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import lw_2stream
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_bwd import lw_noscat_bwd
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import sw_2stream
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw_bwd import sw_2stream_bwd

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. the card ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({len(reports)} of {len(_build.SOURCES)} sources compiled)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # ---- 3. each kernel against its twin at its path's shapes ----
    prob = build_allsky(**MAIN, device=dev, use_aerosols=True)
    nonbanded = build_allsky(**NONBANDED, device=dev, use_aerosols=True)
    variants = []
    rows = (fused_rows(prob, dev, variants) + api_rows(prob, dev, variants)
            + lw2_rows(prob, dev, variants) + lanes_rows(prob, nonbanded))
    torch.cuda.empty_cache()
    rows += adjoint_rows(prob, dev, variants)
    adjoint_report(prob, reports)
    log(f"variants checked against their twins: "
        f"{', '.join(v['name'] for v in variants)}")
    solar = float(prob.gas_sw.kdist.solar_source.double().sum())
    solar_nb = float(nonbanded.gas_sw.kdist.solar_source.double().sum())
    del prob
    torch.cuda.empty_cache()

    # ---- 4. golden gates at the production configuration ----
    step, inputs = build_allsky_step(**PROD, device=dev)
    golden_gate("fused", step(inputs))
    prod = build_allsky(**PROD, device=dev)
    golden_gate("public API", step_fn(prod, "api")(inputs))
    golden_gate("staged", step_fn(prod, "staged")(inputs))
    step, inputs = build_allsky_step(**PROD, device=dev, use_aerosols=True)
    t0 = time.perf_counter()
    step64, inputs64 = build_allsky_step(**PROD, device="cpu",
                                         dtype=torch.float64,
                                         use_aerosols=True)
    twin = dict(zip(("lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dir"),
                    (x.numpy() for x in step64(inputs64))))
    log(f"aerosols float64 twin on the CPU: {time.perf_counter() - t0:.1f} s")
    golden_gate("aerosols fused vs f64 twin", step(inputs), twin)
    t0 = time.perf_counter()
    prod64 = build_allsky(**PROD, device="cpu", dtype=torch.float64)
    twin = dict(zip(("lw_up", "lw_dn"),
                    (x.numpy() for x in lw2_step(prod64)(prod64.inputs))))
    log(f"two-stream float64 twin on the CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    golden_gate("two-stream vs f64 twin", lw2_step(prod)(prod.inputs), twin)
    del prod, prod64, step64, inputs64, twin
    gradient_gates(dev)
    torch.cuda.empty_cache()

    # ---- 5. the paths at 4096 x 72 ----
    counters = {"cloud_props": cloud_props, "fused_lw": lw_fused,
                "fused_sw": sw_fused, "gas_major": gas_major,
                "gas_minor": gas_minor, "gas_rayleigh": gas_rayleigh,
                "solver_lw": lw_noscat, "solver_sw": sw_2stream,
                "solver_lw_lanes": sl.lw_noscat_lanes,
                "solver_lw_pfrac": sl.lw_noscat_lanes_pfrac,
                "solver_sw_lanes": sl.sw_2stream_lanes,
                "solver_sw_combined": sl.sw_2stream_lanes_combined,
                "solver_lw_2str": lw_2stream,
                "fused_lw_bwd": lw_fused_bwd, "fused_sw_bwd": sw_fused_bwd,
                "solver_lw_bwd": lw_noscat_bwd,
                "solver_sw_bwd": sw_2stream_bwd}
    gathers = ("gas_major", "gas_minor", "gas_rayleigh")
    launched = {
        "fused": ("cloud_props", "fused_lw", "fused_sw"),
        "public API": ("cloud_props",) + gathers + ("solver_lw",
                                                    "solver_sw"),
        "staged": ("cloud_props",) + gathers + ("solver_lw_pfrac",
                                                "solver_sw_combined"),
        "staged non-banded": ("cloud_props",) + gathers + (
            "solver_lw_lanes", "solver_sw_lanes"),
        "two-stream": ("cloud_props", "gas_major", "gas_minor",
                       "solver_lw_2str")}

    def drive(name, kind, step, inputs, solar, clouds=True, once=(),
              nonneg=True):
        must = tuple(k for k in launched[kind]
                     if clouds or k != "cloud_props")
        return run_path(name, step, inputs, counters, must,
                        [k for k in counters if k not in must], solar, once,
                        nonneg)

    step, inputs = build_allsky_step(**MAIN, device=dev)
    fused_out, path_launches = drive("fused", "fused", step, inputs, solar)
    launches = {k: path_launches[k] for k in launched["fused"]}
    prob = build_allsky(**MAIN, device=dev, use_aerosols=True)
    for kind, fn in (("public API", "api"), ("staged", "staged")):
        out, path_launches = drive(kind, kind, step_fn(prob, fn), inputs,
                                   solar)
        agree(kind, out, fused_out)
        launches.update({k: path_launches[k] for k in launched[kind]
                         if k not in launches})
        del out
    # the fused step by band: its band sums are its broadband fluxes
    out, _ = drive("fused by band", "fused", step_fn(prob, "step",
                                                     byband=True),
                   inputs, None, once=("fused_lw", "fused_sw"))
    agree("fused by-band sums", tuple(o.sum(-1) for o in out), fused_out)
    del out, fused_out
    # the LW two-stream path, broadband and by band: the two-stream kernel
    # once per step, no no-scattering solver. By band the float32 rounding
    # of the Toon sources (TOL_COND) leaves some bands' downward flux in
    # the top layers below zero, where the exact value is near zero (the
    # float32 twin does the same): finite, and their sums the broadband
    # fluxes
    lw2_out, path_launches = drive("two-stream", "two-stream", lw2_step(prob),
                                   inputs, None, once=("solver_lw_2str",))
    launches["solver_lw_2str"] = path_launches["solver_lw_2str"]
    out, _ = drive("two-stream by band", "two-stream",
                   lw2_step(prob, byband=True), inputs, None,
                   once=("solver_lw_2str",), nonneg=False)
    agree("two-stream by-band sums", tuple(o.sum(-1) for o in out), lw2_out)
    del out, lw2_out
    profile_path("fused", step, inputs)
    profile_path("public API", step_fn(prob, "api"), inputs)
    profile_path("staged", step_fn(prob, "staged"), inputs)
    profile_path("two-stream", lw2_step(prob), inputs)

    # the staged path on the non-banded configuration: the plain lane
    # solvers, against the fused path on the same problem
    nb_staged = step_fn(nonbanded, "staged")
    ref, _ = drive("fused non-banded", "fused",
                   build_allsky_step(**NONBANDED, device=dev)[0],
                   nonbanded.inputs, solar_nb)
    out, path_launches = drive("staged non-banded", "staged non-banded",
                               nb_staged, nonbanded.inputs, solar_nb)
    agree("staged non-banded", out, ref)
    launches.update({k: path_launches[k]
                     for k in ("solver_lw_lanes", "solver_sw_lanes")})
    del nonbanded, nb_staged, ref, out
    torch.cuda.empty_cache()

    # the aerosols and clear-sky configurations
    for config, opts in (("aerosols", dict(use_aerosols=True)),
                         ("clear-sky", dict(use_clouds=False))):
        clouds = opts.get("use_clouds", True)
        step, _ = build_allsky_step(**MAIN, device=dev, **opts)
        ref, _ = drive(f"{config} fused", "fused", step, inputs, solar,
                       clouds)
        if config == "aerosols":
            profile_path("aerosols fused", step, inputs)
        kinds = (("staged", "staged"),) + (
            (("public API", "api"),) if config == "aerosols" else ())
        for kind, fn in kinds:
            out, _ = drive(f"{config} {kind}", kind,
                           step_fn(prob, fn, **opts), inputs, solar, clouds)
            agree(f"{config} {kind}", out, ref)
            del out
        del ref

    # the training steps at full width: the fused path with clouds, then
    # with aerosols, then the public API; each forward kernel of the fused
    # path once per step (cloud optics once per band set), each backward
    # kernel once
    fused_step = {"fused_lw": 1, "fused_sw": 1, "fused_lw_bwd": 1,
                  "fused_sw_bwd": 1, "cloud_props": 2}
    step, _ = build_allsky_step(**MAIN, device=dev)
    got = training_steps("fused", step, inputs, counters, fused_step, ())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    train_loss(step, inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"fused training step: peak device memory {peak} B "
        f"({peak / 1e9:.3f} GB; {(peak - base) / 1e9:.3f} GB above the "
        f"{base / 1e9:.3f} GB held before the step)")
    launches.update({k: got[k] for k in ("fused_lw_bwd", "fused_sw_bwd")})
    profile_path("fused training step", lambda i: train_loss(step, i),
                 inputs)
    step, _ = build_allsky_step(**MAIN, device=dev, use_aerosols=True)
    training_steps("aerosols fused", step, inputs, counters, fused_step, ())
    got = training_steps(
        "public API", step_fn(prob, "api"), inputs, counters,
        {"solver_lw_bwd": 1, "solver_sw_bwd": 1, "solver_lw": 1,
         "solver_sw": 1, "cloud_props": 2},
        ("gas_major", "gas_minor", "gas_rayleigh"))
    launches.update({k: got[k] for k in ("solver_lw_bwd", "solver_sw_bwd")})
    del step
    torch.cuda.empty_cache()

    # ---- 6. multi-angle and optimal-angle LW against the twins; the
    # secant's forms ----
    angles_check(prob, inputs)
    secant_check(prob, inputs)

    # ---- 7. result ----
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
