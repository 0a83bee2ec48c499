#!/usr/bin/env python3
"""The kernel table of the PyTorch port on one CUDA GPU: each hand-written
kernel at the shapes its path gives it, against its plain-PyTorch twin,
timed beside the twin and against the card's lower bound for its work.

    python3 chip_smoke.py

Phases (a kernel that disagrees with its twin ends the run with a
non-zero exit and no result, so the table never times a wrong kernel):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from rte_rrtmgp_tpu_torch/csrc (nvcc, one
     process per source, in parallel), print the build time and ptxas's
     registers and spills;
  3. each kernel against its twin on the device at the shapes its path
     gives it (4096 x 72, LW 256 g-points / 16 bands, SW 224 / 14, ntemp
     14, npres 59; the staged path's plain lane solvers on the non-banded
     configuration, LW 192 / 16 and SW 168 / 14, the only one on which the
     JAX package's dispatch reaches them; the lane solvers with clouds and
     aerosols; the LW two-stream kernel on the two-stream path's inputs,
     clouds at scattering=True), with the median CUDA-event time of both
     and the card's lower bound for the same work (the LW no-scattering
     solver as the public path calls it: one scalar secant, no rescaling,
     no Jacobian; the minor gather as the four out-of-place launches of a
     public-path step, the Rayleigh gather out of place, as the gas optics
     call them); the minor-gas scaling rows and the gas-optics descriptors
     within 0 of their twins and their adjoints against the float64 twins'
     autograd; the aerosol lookup (LW with the clouds folded in; SW and
     the lanes as variants) against its twin; the four adjoint kernels
     against the twins' autograd on the same inputs and seeded flux
     cotangents (see TOL_ADJ); then the
     variants the paths can ask for, each against its twin and timed,
     logged but not in the kernels line: by-band output of the fused LW
     and SW steps and of the LW no-scattering, LW two-stream and SW
     solvers, the LW no-scattering solver with Tang rescaling, the
     Jacobian and a secant field (also by band), the Rayleigh gather's
     split variant (0 + Rayleigh, no ssa), the fused steps with an
     incident flux (LW) and a diffuse one (SW), and their adjoints with
     the same; the adjoints of rows 16 and 17: ptxas registers and
     spills, resident blocks per SM and scratch bytes; the kernels that
     hold their transport on chip (fused_lw, fused_sw, solver_lw in its
     variants, solver_lw_2str, the SW solver's plain and COMBINED
     instantiations and the adjoints solver_sw_bwd and solver_lw_bwd):
     the same, their shared memory per block, cluster size and tallest
     column, broadband and by band; the minor, Rayleigh and major
     gathers' resident blocks per SM; the fused LW and SW steps on the
     RFMIP driver's inputs at 1800 x 61 (100 sites x 18 experiments; the
     SW direct incident flux scaled to each column's TSI, drawn from a
     fixed seed, mu0 = 1 on the night columns) and the LW and SW solvers
     at SSM's 41 g-points on the same profiles, as variants;
  4. each path the cuda tests hold, run once at those shapes with the
     launch counters set to 0 just before it: each kernel's launches
     (see path_launches);
  5. a ``{"kernels": [...], "paths": {...}}`` line (a row's launches are
     those of the first path that launches its kernel), then the last
     line ``{"ok": true, "device": {...}}``.

The bounds of the six kernels the benchmark counts (fused_lw, fused_sw,
gas_minor, solver_sw, fused_lw_bwd, fused_sw_bwd) are its own counts,
torch_bench/work/<kernel>.py at the row's shapes, over the card's peaks,
torch_bench/peaks.py. Pass/fail on the card (paths, goldens, gradients,
launch counts, column-height limits, RFMIP, SSM, the streams) is
``python -m pytest -m cuda tests/test_torch_cuda.py``; the paths'
numbers are the benchmark's (torch_bench/run.py) and
scripts/torch_trace_breakdown.py's.

Without a CUDA device it exits with code 2 before doing anything.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time

MAIN = dict(ncol=4096, nlay=72, ngpt_lw=256, nbnd_lw=16, ngpt_sw=224,
            nbnd_sw=14, ntemp=14, npres=59)
# bands of 12 g-points: the staged path takes the plain lane solvers
NONBANDED = dict(MAIN, ngpt_lw=192, ngpt_sw=168)
# the RFMIP configuration: 100 sites x 18 experiments x 61 layers through
# the RFMIP drivers, LW 256 / 16, SW 224 / 14; each column's TSI drawn
# from seed 5 in [1300, 1420] W/m2
RFMIP = dict(nsite=100, nlay=61, nexp=18)
RFMIP_TSI = (5, 1300.0, 1420.0)
# kernel vs twin, same float32 inputs: the two differ only in summation
# order, fused multiply-adds and expf's last bit. The gathers (cloud
# optics, major/minor/Rayleigh) are lerps of a few products per value;
# the solvers and fused steps sum 224-256 g-points over 72-layer
# recurrences. Bounds are relative to the largest twin value (measured
# on an H100: gathers below 1e-7, fluxes about 2e-7).
TOL_GATHER = 1e-6    # x max |twin|
TOL_FLUX = 2e-6      # x max |twin| (about 3e-3 W/m2 on LW fluxes)
REPS = 5
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
# the minor-scaling adjoint against the float64 twin's autograd: each
# cotangent within this share of its largest value (float32 rounding of
# a few products per window and cell)
TOL_SCALE_ADJ = 1e-5
# the descriptors' adjoint against the float64 twin's autograd: each
# cotangent within this share of its largest value
TOL_DESC_ADJ = 1e-6
# float operations per unit of work of the rows the benchmark does not
# count, counted from the kernels' arithmetic (an exp or a division
# counts as one); they stay here until the benchmark gives these kernels
# a roofline. The others (OPS_MAJOR_CORNER, OPS_LW_LAYER, ...) are read
# from torch_bench/work (bench()).
OPS_RAYLEIGH_SPLIT = 16    # 2-D lerp (14), x scale, 0 + it
OPS_SCALE = 5              # per (window, cell): density, fraction, mask
OPS_SCALE_BWD = 12         # per (window, cell): the scaling's adjoint
OPS_CLOUD = 27             # per (cell, band): 2 phases x (3 lerps + 3)
OPS_LW_RESCALE = 14        # Tang terms and the second down sweep
OPS_PFRAC_SOURCES = 8      # layer source, two level geometric means, cloud
# per (column, layer, g-point) of the LW two-stream solve: Meador-Weaver
# Rdif/Tdif (21), the Toon sources (27), the adding build and sweep (19),
# the level sums (2)
OPS_LW2_LAYER = 69
# the gas descriptors per cell: the column amounts (a product per gas, the
# dry column's 12), the temperature and pressure coefficients (12, a log),
# and per flavor and temperature corner the mix, eta and its split (8);
# the adjoint: per flavor and corner 12, per gas 3, the cell's terms 16
OPS_DESC_CELL = 24
OPS_DESC_FLAVOR = 8
OPS_DESC_BWD_CELL = 16
OPS_DESC_BWD_FLAVOR = 12


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


def queued_ms(fn, n=100, reps=REPS):
    """Median over ``reps`` runs of fn's device time per call, in ms, for
    a kernel the card runs faster than the host launches it (where
    :func:`cuda_ms` times the host): the card first spins
    (``torch.cuda._sleep``, twice the host's time to queue the calls at
    2 GHz) while the host queues ``n`` calls, so they run back to back
    and the events around them time the card alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    cycles = int(2.0 * (time.perf_counter() - t0) * 2e9)

    def once():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    return statistics.median(once() for _ in range(reps))


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


def bench(kernel):
    """The benchmark's count of ``kernel``'s work,
    torch_bench/work/<kernel>.py: ``work(shapes)`` -> (bytes, operations)
    of one step's launches, and its OPS_* per unit of work."""
    from torch_bench.harness import load
    return load("work", kernel)


def shapes(gas_lw, gas_sw, ncol, nlay, clouds=True):
    """The sizes the benchmark's work counts read, as
    torch_bench/traffic/generator.shapes derives them from a
    configuration: here the configuration, in torch_bench/configs' keys,
    of the problem a row runs on. generator.shapes counts each minor
    window a band wide, as the port's synthetic k-distributions make
    them."""
    from torch_bench.traffic import generator
    lw = gas_lw.kdist
    config = dict(ncol=ncol, nlay=nlay, ntemp=lw.kmajor.shape[0],
                  neta=lw.neta, npres=lw.kmajor.shape[2] - 1,
                  ntemp_planck=lw.totplnk.shape[0])
    for side, gas in (("lw", gas_lw), ("sw", gas_sw)):
        kd = gas.kdist
        config[f"kdist_{side}"] = dict(
            ngpt=kd.ngpt, nbnd=gas.grid.nband,
            nminor_lower=len(kd.minor_lower.limits_gpt),
            nminor_upper=len(kd.minor_upper.limits_gpt))
    return dict(generator.shapes(config), clouds=clouds)


def bound(moved_bytes, ops):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the float32 peak (torch_bench/peaks.py), whichever is
    larger."""
    from torch_bench import peaks
    t_bytes = moved_bytes / peaks.BYTES_PER_S * 1e3
    t_ops = ops / peaks.F32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved_bytes, ops=ops)


def check_kernel(name, kernel, plain, args, tol, source, replaces, work,
                 fresh=lambda a: a, ill_conditioned=False, timer=None):
    """Kernel vs twin on fresh copies of the inputs (``fresh`` clones what
    a kernel updates in place), then both timed, the kernel by ``timer``
    (default :func:`cuda_ms`). ``work`` is (bytes the
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
    ms = (timer or cuda_ms)(lambda: kernel(args))
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
    s = shapes(prob.gas_lw, prob.gas_sw, ncol, nlay)
    work = {k: bench(k).work(s) for k in ("fused_lw", "fused_sw")}
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
                     work["fused_lw"]),
        check_kernel("fused_sw", sw_fused, sw_fused_plain, sw, TOL_FLUX,
                     "rte_rrtmgp_tpu_torch/csrc/fused_sw.cu",
                     "rte_rrtmgp_tpu/ops/pallas/fused_sw.py:309",
                     work["fused_sw"]),
    ]
    gen = torch.Generator(device=dev).manual_seed(3)
    inc = 3.0 * torch.rand(lw.inc.shape, generator=gen, device=dev)
    nbl, nbs = lw.totplnk.shape[1], sw.nband
    # the benchmark's count of the broadband step, and the by-band fluxes
    # beyond its broadband ones
    for name, kernel, plain, x, extra in (
            ("fused_lw byband", lw_fused, lw_fused_plain,
             lw._replace(byband=True), 2 * (nbl - 1)),
            ("fused_sw byband", sw_fused, sw_fused_plain,
             sw._replace(byband=True), 3 * (nbs - 1)),
            ("fused_lw inc", lw_fused, lw_fused_plain, lw._replace(inc=inc),
             0),
            ("fused_sw incdif", sw_fused, sw_fused_plain,
             sw._replace(incdif=0.05 * sw.inc * inc[:sw.inc.shape[0]]), 0)):
        src = "fused_lw" if name.startswith("fused_lw") else "fused_sw"
        moved, ops = work[src]
        variants.append(check_kernel(
            name, kernel, plain, x, TOL_FLUX,
            f"rte_rrtmgp_tpu_torch/csrc/{src}.cu", rows[1 + (
                src == "fused_sw")]["replaces"],
            (moved + extra * nlev * ncol * 4, ops)))
    return rows


def scale_rows(prob, variants):
    """Phase 3, the minor-gas scaling rows of every window in one launch
    (csrc/minor_scale.cu; no TPU kernel: the JAX package forms them in
    plain JAX, rte_rrtmgp_tpu/ops/gas_optics.py:297-309) and their
    adjoint, LW and SW, on the layer-major views the fused gas optics hand
    over (play.T, col_gas.transpose(1, 2)): the rows within 0 of the
    twin's (the per-window loop), the adjoint's cotangents' error against
    the float64 twin's autograd on seeded cotangents beside TOL_SCALE_ADJ
    (test_minor_scale_* hold both); each timed beside its twin (the loop; the
    float32 twin's autograd), bound by the bytes it reads and writes; the
    kernels by :func:`queued_ms` (the card runs them faster than the host
    launches them), the twins by :func:`cuda_ms` (the host's pace). The
    LW call's rows are the kernels line's; the SW call's forward goes into
    ``variants``, its adjoint is logged."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.minor_scale import (
        minor_scale, minor_scale_bwd, minor_scale_plain)
    inp = prob.inputs
    rows = []
    for band, gas in (("lw", prob.gas_lw), ("sw", prob.gas_sw)):
        cg, _, h2o = gas.col_gas(inp.play, inp.plev, inp.gas_concs)
        x = (inp.play.T, inp.tlay.T, cg.transpose(1, 2))
        tropo = gas.interp(*x).tropo
        args = (tropo, *x, h2o, gas.minor_windows, gas.minor_scale_table)
        nwin, ncell = len(gas.minor_windows), tropo.numel()
        cells = nbytes(*args[:4])
        fwd = check_kernel(
            f"minor_scale {band}", lambda a: minor_scale(*a),
            lambda a: minor_scale_plain(*a), args, 0.0,
            "rte_rrtmgp_tpu_torch/csrc/minor_scale.cu",
            "none (plain JAX, rte_rrtmgp_tpu/ops/gas_optics.py:297-309)",
            (cells + nwin * ncell * 4, OPS_SCALE * nwin * ncell),
            timer=queued_ms)
        gen = torch.Generator(device=tropo.device).manual_seed(9)
        g = torch.randn((nwin,) + tuple(tropo.shape), generator=gen,
                        device=tropo.device)
        got = minor_scale_bwd(*args, g)

        def twin_grad(dtype):
            xs = [t.detach().to(dtype).requires_grad_() for t in x]
            out = minor_scale_plain(tropo, *xs, h2o, gas.minor_windows)
            grads = torch.autograd.grad(out, xs, g.to(dtype))
            return grads[2], grads[0], grads[1]
        ref = twin_grad(torch.float64)
        errs = []
        for name, a, r in zip(("col_gas", "play", "tlay"), got, ref):
            scale = float(r.abs().max())
            errs.append(float((a.double() - r).abs().max()))
            log(f"kernel minor_scale_bwd {band}: {name} cotangent max_abs_err"
                f" {errs[-1]:.3e} against the float64 twin (limit "
                f"{TOL_SCALE_ADJ * scale:.3e})")
        del ref
        ms = queued_ms(lambda: minor_scale_bwd(*args, g))
        plain_ms = cuda_ms(lambda: twin_grad(torch.float32), reps=3)
        b = bound(cells + nbytes(g) + nbytes(got),
                  OPS_SCALE_BWD * nwin * ncell)
        log(f"kernel minor_scale_bwd {band}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (the twin's autograd), bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e9:.3f} GB, {b['ops'] / 1e9:.3f} Gop)")
        fwd["name"] = "minor_scale" if band == "lw" else "minor_scale sw"
        (rows if band == "lw" else variants).append(fwd)
        if band == "lw":
            rows.append(dict(
                name="minor_scale_bwd", route="cuda",
                source="rte_rrtmgp_tpu_torch/csrc/minor_scale.cu",
                replaces=fwd["replaces"], max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], library_ms=None))
        del got, g, args
    torch.cuda.empty_cache()
    return rows


def descriptor_rows(prob, variants):
    """Phase 3, the gas-optics descriptors of one call in one launch
    (csrc/gas_descriptors.cu; no TPU kernel: the JAX package forms the
    column amounts and the interpolation coefficients in plain JAX,
    rte_rrtmgp_tpu/ops/gas_optics.py) and their adjoint, LW and SW, in the
    fused layout (layer-major outputs) and the public one: the float
    outputs within 0 of the twin's (ops/gas_optics.py::column_amounts and
    interpolation), the adjoint's cotangents of play, tlay, plev and the
    water vapour, their error against the float64 twin's autograd on
    seeded cotangents beside TOL_DESC_ADJ (test_gas_descriptors_* hold
    both); each timed beside its twin,
    the kernels by :func:`queued_ms`, the twins by :func:`cuda_ms`, bound
    by the bytes each reads and writes. The LW fused call's forward and
    adjoint are the kernels lines; the others go into ``variants`` or are
    logged."""
    import torch
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import vmr_rows
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_descriptors import (
        gas_descriptors, gas_descriptors_bwd, gas_descriptors_plain)
    inp = prob.inputs
    ncol, nlay = inp.play.shape
    ncell = ncol * nlay
    rows = []
    for band, gas in (("lw", prob.gas_lw), ("sw", prob.gas_sw)):
        vmrs, h2o = vmr_rows(gas.kdist, inp.gas_concs, ncol, nlay)
        tables = gas.interp_tables[torch.float32]
        nflav = tables.flavor.shape[1]
        for layout in ("fused", "public"):
            lm = layout == "fused"
            args = (inp.play, inp.tlay, inp.plev, vmrs, None, h2o, tables,
                    lm)
            floats = lambda cg, co: (cg, co.ftemp, co.fpress, co.col_mix,
                                     co.feta)
            got = gas_descriptors(*args)
            moved = nbytes(inp.play, inp.tlay, inp.plev, *vmrs, *got)
            label = f"gas_descriptors {band} {layout}"
            fwd = check_kernel(
                label, lambda a: floats(*gas_descriptors(*a)),
                lambda a: floats(*gas_descriptors_plain(*a)), args, 0.0,
                "rte_rrtmgp_tpu_torch/csrc/gas_descriptors.cu",
                "none (plain JAX, rte_rrtmgp_tpu/ops/gas_optics.py)",
                (moved, ncell * (OPS_DESC_CELL + len(vmrs)
                                 + 2 * nflav * OPS_DESC_FLAVOR)),
                timer=queued_ms)
            gen = torch.Generator(device=inp.play.device).manual_seed(19)
            g = tuple(torch.randn(x.shape, generator=gen,
                                  device=inp.play.device)
                      for x in floats(*got))
            req = tuple(None if v is None else
                        v.expand(ncol, nlay).contiguous().requires_grad_(
                            k == h2o - 1) for k, v in enumerate(vmrs))
            plev = inp.plev.clone().requires_grad_()
            bargs = (inp.play, inp.tlay, plev, req, None, h2o, tables, lm,
                     g)
            with torch.no_grad():
                dg = gas_descriptors_bwd(*bargs)
            dg = (dg[0], dg[1], dg[2], dg[4][h2o - 1])

            def twin_grad(dtype):
                tab = gas.interp_tables[dtype]
                xs = [t.detach().to(dtype).requires_grad_()
                      for t in (inp.play, inp.tlay, inp.plev,
                                req[h2o - 1])]
                vs = tuple(xs[3] if k == h2o - 1 else
                           (None if v is None else v.detach())
                           for k, v in enumerate(req))
                cg, co = gas_descriptors_plain(xs[0], xs[1], xs[2], vs,
                                               None, h2o, tab, lm)
                return torch.autograd.grad(
                    floats(cg, co), xs, tuple(x.to(dtype) for x in g))
            want = twin_grad(torch.float64)
            errs = []
            for name, a, r in zip(("play", "tlay", "plev", "h2o"), dg, want):
                scale = float(r.abs().max())
                errs.append(float((a.double() - r).abs().max()) / scale)
                log(f"kernel {label} adjoint: {name} cotangent max_abs_err "
                    f"{errs[-1]:.3e} of the float64 twin's largest (limit "
                    f"{TOL_DESC_ADJ:.0e})")
            del want
            with torch.no_grad():
                ms = queued_ms(lambda: gas_descriptors_bwd(*bargs))
            plain_ms = cuda_ms(lambda: twin_grad(torch.float32), reps=3)
            b = bound(moved + nbytes(*g) + nbytes(*dg),
                      ncell * (OPS_DESC_BWD_CELL + 3 * len(vmrs)
                               + 2 * nflav * OPS_DESC_BWD_FLAVOR))
            log(f"kernel {label} adjoint: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms (the twin's autograd), bound "
                f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
                f"({b['bytes'] / 1e9:.3f} GB, {b['ops'] / 1e9:.3f} Gop)")
            if band == "lw" and lm:
                fwd["name"] = "gas_descriptors"
                rows.append(fwd)
                rows.append(dict(
                    name="gas_descriptors_bwd", route="cuda",
                    source=fwd["source"], replaces=fwd["replaces"],
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=None))
            else:
                variants.append(fwd)
            del got, g, dg, bargs
    torch.cuda.empty_cache()
    return rows


def aerosol_rows(prob, variants):
    """Phase 3, the aerosol lookup of one gas-optics call in one launch
    (csrc/aerosol_props.cu; no TPU kernel: the JAX package forms it in
    plain JAX, rte_rrtmgp_tpu/models/rrtmgp/aerosol_optics.py:180-243) on
    the all-sky example's aerosols, as the all-sky step calls it: LW the
    absorption with the clouds' folded in (the kernels line's row), SW
    the delta-scaled aerosols combined with the clouds', and the lanes
    alone (both into ``variants``); each against its twin beside
    TOL_GATHER, the kernel timed by :func:`queued_ms`, the twin by
    :func:`cuda_ms`, bound by torch_bench/work/aerosol_props.py's count of
    one launch (the lanes alone: the LW launch's)."""
    from rte_rrtmgp_tpu_torch.ops.kernels import aerosol_props as ap
    inp = prob.inputs
    ncol, nlay = inp.play.shape
    count = bench("aerosol_props").launch_work
    rows = []
    for name, aer, cld, mode in (
            ("aerosol_props", prob.aer_lw, prob.cld_lw, ap.LW),
            ("aerosol_props sw", prob.aer_sw, prob.cld_sw, ap.SW),
            ("aerosol_props lanes", prob.aer_lw, None, ap.LANES)):
        cloud = None if cld is None else cld.cloud_optics_lanes(
            inp.lwp, inp.iwp, inp.rel, inp.dei)
        args = (inp.aero_type, inp.aero_size, inp.aero_mass, inp.relhum,
                aer.lut, aer.offsets, cloud, mode)
        shapes = dict(nlay=nlay, aerosol_nbin=aer.nbin, aerosol_nrh=aer.nrh)
        row = check_kernel(
            name, lambda a: ap.aerosol_props(*a),
            lambda a: ap.aerosol_props_plain(*a), args, TOL_GATHER,
            "rte_rrtmgp_tpu_torch/csrc/aerosol_props.cu",
            "none (plain JAX, rte_rrtmgp_tpu/models/rrtmgp/"
            "aerosol_optics.py:180-243)",
            count(shapes, ncol, aer.nbnd, mode == ap.SW), timer=queued_ms)
        (rows if mode == ap.LW else variants).append(row)
    return rows


def api_rows(prob, dev, variants):
    """Phase 3, the public-API path's kernels: the staged major, minor and
    Rayleigh gathers and the LW and SW solvers, on inputs prepared as the
    path prepares them (the minor gather as the four launches of a step:
    LW and SW, lower and upper atmosphere); into ``variants`` the solvers
    by band."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.gas_optics import minor_scaling
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
    s = shapes(gl, gs, ncol, nlay)
    lw_ops, sw_ops = bench("fused_lw"), bench("fused_sw")

    def cells(gas):
        col_gas, col_dry, idx_h2o = gas.col_gas(inp.play, inp.plev,
                                                inp.gas_concs)
        return gas.interp(inp.play, inp.tlay, col_gas), col_gas, col_dry, \
            idx_h2o

    def minor_calls(gas, co, col_gas, idx_h2o):
        """The lower and upper atmosphere's gas_minor arguments."""
        kd = gas.kdist
        tau = gas_major_plain(co, kd.kmajor, None, gas.gpoint_flavor)[0]
        nlo = len(kd.minor_lower)
        return tuple(
            (tau, co, ktab, tuple(m[1:] for m in gas.minors
                                  if bool(m[0]) == lower), meta,
             minor_scaling(co, mset, lower=lower, play=inp.play,
                           tlay=inp.tlay, col_gas=col_gas, idx_h2o=idx_h2o))
            for lower, mset, ktab, meta in (
                (True, kd.minor_lower, kd.kminor_lower, gas.minor_meta[:nlo]),
                (False, kd.minor_upper, kd.kminor_upper,
                 gas.minor_meta[nlo:])))

    co, col_gas, _, idx_h2o = cells(gl)
    kd = gl.kdist
    ngl = kd.ngpt
    # the kernel gathers from the interleaved table the gas optics hold;
    # the function's inputs are the descriptors and the two tables
    major = (co, kd.kmajor, kd.planck_frac, gl.gpoint_flavor,
             gl.kmajor_pfrac)
    rows = [check_kernel(
        "gas_major", lambda a: gas_major(*a), lambda a: gas_major_plain(*a),
        major, TOL_GATHER, "rte_rrtmgp_tpu_torch/csrc/gas_major.cu",
        "rte_rrtmgp_tpu/ops/pallas/major_gather.py:188",
        (nbytes(major[:4]) + 2 * ncell * ngl * 4,
         ncell * ngl * 8 * (lw_ops.OPS_MAJOR_CORNER
                            + lw_ops.OPS_PFRAC_CORNER)))]
    minor = minor_calls(gl, co, col_gas, idx_h2o)

    co, col_gas, col_dry, idx_h2o = cells(gs)
    minor += minor_calls(gs, co, col_gas, idx_h2o)
    # out of place, as the gas optics call it (models/rrtmgp/gas_optics.py
    # ::_minor): tau read, a new tensor written
    oop_minor = lambda f: lambda a: tuple(
        f(*c, out=torch.empty_like(c[0])) for c in a)
    rows.append(check_kernel(
        "gas_minor", oop_minor(gas_minor), oop_minor(gas_minor_plain),
        minor, TOL_GATHER, "rte_rrtmgp_tpu_torch/csrc/gas_minor.cu",
        "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:100",
        bench("gas_minor").work(s)))
    del minor

    kds = gs.kdist
    ngs = kds.ngpt
    tau = gas_major_plain(co, kds.kmajor, None, gs.gpoint_flavor)[0]
    rayl = (tau, co, kds.krayl, gs.gpoint_flavor,
            (col_gas[idx_h2o] + col_dry).contiguous())
    descr = nbytes(co.jtemp, co.ftemp, co.tropo, co.jeta, co.feta,
                   kds.krayl, rayl[4])
    # out of place, as the gas optics call it (models/rrtmgp/gas_optics.py
    # ::_rayleigh): tau read, a new tau and the ssa written; then, into
    # ``variants``, the staged path's split variant: 0 + Rayleigh, no ssa,
    # no tau read
    oop = lambda f, scattering: lambda a: f(
        *a, scattering, out=torch.empty_like(tau))
    rows.append(check_kernel(
        "gas_rayleigh", oop(gas_rayleigh, True),
        oop(gas_rayleigh_plain, True), rayl, TOL_GATHER,
        "rte_rrtmgp_tpu_torch/csrc/gas_minor.cu",
        "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:161",
        (descr + 3 * tau.numel() * 4, ncell * ngs * sw_ops.OPS_RAYLEIGH)))
    split = (None,) + rayl[1:]
    variants.append(check_kernel(
        "gas_rayleigh split", oop(gas_rayleigh, False),
        oop(gas_rayleigh_plain, False), split, TOL_GATHER,
        rows[-1]["source"], rows[-1]["replaces"],
        (descr + tau.numel() * 4, ncell * ngs * OPS_RAYLEIGH_SPLIT)))
    del rayl, split, tau, co, col_gas, col_dry

    # the LW solver as the public path calls it (rte_lw on 1scl props: one
    # scalar secant, no rescaling, no Jacobian, zero incident flux), on the
    # path's gas optics and sources; then, into ``variants``, by band, and
    # with Tang rescaling, the Jacobian, an incident flux and
    # per-(column, g-point) secants, broadband and by band
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    props, src = gl.gas_optics_lw(inp.play, inp.plev, inp.tlay, inp.tsfc,
                                  inp.gas_concs, tlev=inp.tlev, top_at_1=True)
    shape = tuple(props.tau.shape)
    bc = (ncol, ngl)
    emis = inp.sfc_emis[:, :1].expand(bc).contiguous()
    path = (props.tau, src.lay_source, src.lev_source, emis, src.sfc_source,
            torch.zeros_like(emis),
            dict(ds=float(GAUSS_DS[0][0]), weight=float(GAUSS_WTS[0][0])))
    call = lambda f: lambda a: f(*a[:6], **a[6])
    rows.append(check_kernel(
        "solver_lw", call(lw_noscat), call(lw_noscat_plain), path, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/solver_lw.cu",
        "rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py:239",
        (nbytes(path) + 2 * ncol * (nlay + 1) * 4,
         ncol * nlay * ngl * lw_ops.OPS_LW_LAYER)))
    resc = (props.tau, src.lay_source, src.lev_source, rand(bc, 0.8, 1.0),
            src.sfc_source, rand(bc, 0.0, 2.0),
            dict(ds=gl.compute_optimal_angles(props), weight=1.0,
                 sfc_src_jac=src.sfc_source_jac, ssa=rand(shape, 0.0, 0.6),
                 g=rand(shape, 0.0, 0.9)))
    nbl = gl.grid.nband
    bands = dict(gpt2band=gl.gpt2band, nband=nbl)
    layer = lw_ops.OPS_LW_LAYER
    for name, x, nout, ops in (
            ("solver_lw byband", path[:6] + (dict(path[6], **bands),),
             2 * nbl, layer),
            ("solver_lw rescaled", resc, 3, layer + OPS_LW_RESCALE),
            ("solver_lw rescaled byband", resc[:6] + (dict(resc[6], **bands),),
             2 * nbl + 1, layer + OPS_LW_RESCALE)):
        variants.append(check_kernel(
            name, call(lw_noscat), call(lw_noscat_plain), x, TOL_FLUX,
            rows[-1]["source"], rows[-1]["replaces"],
            (nbytes(x) + nout * ncol * (nlay + 1) * 4,
             ncol * nlay * ngl * ops)))
    del path, resc, props, src

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
    moved, ops = bench("solver_sw").work(s)
    rows.append(check_kernel(
        "solver_sw", lambda a: sw_2stream(*a), lambda a: sw_2stream_plain(*a),
        sw, TOL_FLUX, "rte_rrtmgp_tpu_torch/csrc/solver_sw.cu",
        "rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py:222", (moved, ops)))
    # the benchmark's count of the broadband solve, and the by-band fluxes
    # beyond its broadband ones
    nbs = gs.grid.nband
    swb = sw + (gs.gpt2band,)
    variants.append(check_kernel(
        "solver_sw byband", lambda a: sw_2stream(*a, nband=nbs),
        lambda a: sw_2stream_plain(*a, nband=nbs), swb, TOL_FLUX,
        rows[-1]["source"], rows[-1]["replaces"],
        (moved + 3 * (nbs - 1) * ncol * (nlay + 1) * 4, ops)))
    return rows


def two_stream_optics(prob, i):
    """The LW two-stream path's optics and sources on inputs ``i``: gas
    optics with scattering, the 2-stream cloud optics added."""
    from rte_rrtmgp_tpu_torch.optical_props import increment
    props, src = prob.gas_lw.gas_optics_lw(
        i.play, i.plev, i.tlay, i.tsfc, i.gas_concs, tlev=i.tlev,
        scattering=True, top_at_1=True)
    return increment(props, prob.cld_lw.cloud_optics(
        i.lwp, i.iwp, i.rel, i.dei, scattering=True)), src


def lw2_rows(prob, dev, variants):
    """Phase 3, the LW two-stream kernel on the two-stream path's inputs
    (what rte_lw hands it: no incident flux); into ``variants`` the same
    by band. The layer source is in its signature but never read, so its
    bytes are not counted."""
    import torch
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw_2str import (
        lw_2stream, lw_2stream_plain)
    i = prob.inputs
    props, src = two_stream_optics(prob, i)
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
    lw_layer = bench("fused_lw").OPS_LW_LAYER
    sw_ops = bench("fused_sw")
    for name, p, banded, kernel, plain, src, line, ops in (
            ("solver_lw_lanes", nonbanded, False, sl.lw_noscat_lanes,
             sl.lw_noscat_lanes_plain, src_lw, 224, lw_layer),
            ("solver_lw_pfrac", prob, True, sl.lw_noscat_lanes_pfrac,
             sl.lw_noscat_lanes_pfrac_plain, src_lw, 372,
             lw_layer + OPS_PFRAC_SOURCES),
            ("solver_sw_lanes", nonbanded, False, sl.sw_2stream_lanes,
             sl.sw_2stream_lanes_plain, src_sw, 675, sw_ops.OPS_SW_LAYER),
            ("solver_sw_combined", prob, True,
             sl.sw_2stream_lanes_combined,
             sl.sw_2stream_lanes_combined_plain, src_sw, 774,
             sw_ops.OPS_SW_LAYER + sw_ops.OPS_SW_COMBINE)):
        sw = name.startswith("solver_sw")
        args = (sw_args if sw else lw_args)(p, banded)
        ngpt, nlay, ncol = args[0].shape
        nout = (3 if sw else 2) * (nlay + 1) * ncol * 4
        rows.append(check_kernel(
            name, call(kernel), call(plain), args, TOL_FLUX, src,
            f"{lanes}:{line}", (nbytes(args) + nout, ncol * nlay * ngpt * ops)))
        del args
    return rows


def rfmip_problem(dev):
    """The RFMIP configuration (RFMIP, RFMIP_TSI) with the flagship LW
    and SW k-distributions (seed 0), on ``dev``: (data, gas_lw, gas_sw)."""
    import dataclasses
    import numpy as np
    from rte_rrtmgp_tpu_torch.drivers.rfmip import synthetic_rfmip
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist
    data = synthetic_rfmip(**RFMIP)
    seed, lo, hi = RFMIP_TSI
    data = dataclasses.replace(data, tsi=np.random.default_rng(seed).uniform(
        lo, hi, data.ncol).astype(np.float32))
    kw = dict(ntemp=MAIN["ntemp"], npres=MAIN["npres"], device=dev)
    return (data, GasOpticsRRTMGP(synthetic_kdist(
        sw=False, ngpt=MAIN["ngpt_lw"], nbnd=MAIN["nbnd_lw"], **kw)),
        GasOpticsRRTMGP(synthetic_kdist(sw=True, ngpt=MAIN["ngpt_sw"],
                                        nbnd=MAIN["nbnd_sw"], **kw)))


def rfmip_rows(rf, dev, variants):
    """Phase 3, into ``variants``: rows 2 and 3 on the RFMIP driver's
    fused inputs at 1800 x 61 (61 layers, not a multiple of the ring
    sweeps' 4; the SW direct incident flux the solar source scaled to
    each column's TSI, mu0 = 1 on the night columns), and rows 7 and 9 at
    SSM's 41 g-points in 41 bands (a chunk of 32 and a ragged one of 9) on
    the same profiles, as the driver's generic route calls them."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers import rfmip
    from rte_rrtmgp_tpu_torch.models.ssm import (ssm_lw_defaults,
                                                 ssm_sw_defaults)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_lw import (lw_fused,
                                                           lw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.fused_sw import (sw_fused,
                                                           sw_fused_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_lw import (lw_noscat,
                                                            lw_noscat_plain)
    from rte_rrtmgp_tpu_torch.ops.kernels.solver_sw import (sw_2stream,
                                                            sw_2stream_plain)
    from rte_rrtmgp_tpu_torch.ops.solver_lw import GAUSS_DS, GAUSS_WTS
    data, g_lw, g_sw = rf
    x = rfmip._inputs(data, g_lw)
    ncol, nlay = x["play"].shape
    nlev = nlay + 1
    args, kw = rfmip._lw_fused_args(g_lw, True, *rfmip._lw_args(x))
    lw = g_lw.lw_fused_inputs(*args, **kw)
    usecol, mu0 = rfmip._sun(x["sza"])
    args, kw = rfmip._sw_fused_args(g_sw, True, x["play"], x["plev"],
                                    x["tlay"], x["sfc_alb"], x["tsi"], mu0,
                                    x["gas_concs"])
    sw = g_sw.sw_fused_inputs(*args, **kw)
    log(f"rfmip: {ncol} columns x {nlay} layers, {int((~usecol).sum())} "
        f"night columns, TSI {float(x['tsi'].min()):.1f}-"
        f"{float(x['tsi'].max()):.1f} W/m2")
    s = shapes(g_lw, g_sw, ncol, nlay, clouds=False)
    variants.append(check_kernel(
        "fused_lw rfmip", lw_fused, lw_fused_plain, lw, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/fused_lw.cu",
        "rte_rrtmgp_tpu/ops/pallas/fused_lw.py:368",
        bench("fused_lw").work(s)))
    variants.append(check_kernel(
        "fused_sw rfmip tsi", sw_fused, sw_fused_plain, sw, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/fused_sw.cu",
        "rte_rrtmgp_tpu/ops/pallas/fused_sw.py:309",
        bench("fused_sw").work(s)))
    del lw, sw

    ssm = ssm_lw_defaults(device=dev)
    props, src = ssm.gas_optics_lw(x["play"], x["plev"], x["tlay"],
                                   x["sfc_t"], x["gas_concs"],
                                   tlev=x["tlev"], top_at_1=True)
    ngpt = ssm.ngpt
    emis = x["sfc_emis"][:, None].expand(-1, ngpt).contiguous()
    path = (props.tau, src.lay_source, src.lev_source, emis, src.sfc_source,
            torch.zeros_like(emis),
            dict(ds=float(GAUSS_DS[0][0]), weight=float(GAUSS_WTS[0][0])))
    call = lambda f: lambda a: f(*a[:6], **a[6])
    variants.append(check_kernel(
        "solver_lw ssm", call(lw_noscat), call(lw_noscat_plain), path,
        TOL_FLUX, "rte_rrtmgp_tpu_torch/csrc/solver_lw.cu",
        "rte_rrtmgp_tpu/ops/pallas/solver_lw_kernel.py:239",
        (nbytes(path) + 2 * ncol * nlev * 4,
         ncol * nlay * ngpt * bench("fused_lw").OPS_LW_LAYER)))
    ssm = ssm_sw_defaults(device=dev)
    props, toa = ssm.gas_optics_sw(x["play"], x["plev"], x["tlay"],
                                   x["gas_concs"], top_at_1=True)
    alb = x["sfc_alb"][:, None].expand(-1, ngpt).contiguous()
    args = (props.tau, props.ssa, props.g,
            mu0[:, None].expand(-1, nlay).contiguous(), alb, alb,
            (toa * (x["tsi"] / toa.sum(-1))[:, None]).contiguous())
    variants.append(check_kernel(
        "solver_sw ssm", lambda a: sw_2stream(*a),
        lambda a: sw_2stream_plain(*a), args, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/solver_sw.cu",
        "rte_rrtmgp_tpu/ops/pallas/solver_sw_kernel.py:222",
        bench("solver_sw").work(dict(ncol=ncol, nlay=nlay, ngpt_sw=ngpt))))


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


def check_adjoint(name, kernel, plain, make, source, replaces, work):
    """An adjoint kernel against its plain version (the twin's autograd)
    on the same inputs and seeded cotangents, ``make(n)`` building them
    for n columns: compared at 4096 columns, or at the largest halving
    whose twin graph fits in memory (printed); each cotangent within
    TOL_ADJ of its largest twin value, or, where the float32 twin is
    itself further than that from the float64 twin (run on the card with
    the float32 constants), within TOL_ADJ of the float64 twin's.
    The kernel is timed at 4096; ``work(args, cotangents)`` gives the
    bytes and operations of its bound there."""
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
    b = bound(*work(args, as_tuple(kernel(args))))
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

    ncol, ngl, ngs = MAIN["ncol"], gl.ngpt, gs.ngpt
    s = shapes(gl, gs, ncol, nlay)
    flw_bwd, fsw_bwd = bench("fused_lw_bwd"), bench("fused_sw_bwd")
    work_flw = lambda a, o: flw_bwd.work(s)
    work_fsw = lambda a, o: fsw_bwd.work(s)
    # the solver adjoints: the bytes of their arguments and cotangents, and
    # the fused adjoints' per-(cell, g-point) count of the transport's
    work_lw = lambda a, o: (nbytes(a) + nbytes(o),
                            ncol * nlay * ngl * flw_bwd.OPS_LW_ADJ)
    work_sw = lambda a, o: (nbytes(a) + nbytes(o),
                            ncol * nlay * ngs * fsw_bwd.OPS_SW_ADJ)
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
                      f"{pallas}/fused_lw_bwd.py:506", work_flw),
        check_adjoint("fused_sw_bwd incdif", lambda a: fsw.sw_fused_bwd(*a),
                      lambda a: fsw.sw_fused_bwd_plain(*a),
                      fused_sw_incdif_args, f"{csrc}/fused_sw_bwd.cu",
                      f"{pallas}/fused_sw_bwd.py:694", work_fsw)]
    return [
        check_adjoint("fused_lw_bwd", lambda a: flw.lw_fused_bwd(*a),
                      lambda a: flw.lw_fused_bwd_plain(*a), fused_lw_args,
                      f"{csrc}/fused_lw_bwd.cu", f"{pallas}/fused_lw_bwd.py:506",
                      work_flw),
        check_adjoint("fused_sw_bwd", lambda a: fsw.sw_fused_bwd(*a),
                      lambda a: fsw.sw_fused_bwd_plain(*a), fused_sw_args,
                      f"{csrc}/fused_sw_bwd.cu", f"{pallas}/fused_sw_bwd.py:694",
                      work_fsw),
        check_adjoint("solver_lw_bwd",
                      lambda a: slw.lw_noscat_bwd(*a, ds=ds, weight=wt),
                      lambda a: slw.lw_noscat_bwd_plain(*a, ds=ds, weight=wt),
                      lw_args, f"{csrc}/solver_lw_bwd.cu",
                      f"{pallas}/solver_lw_bwd.py:207", work_lw),
        check_adjoint("solver_sw_bwd", lambda a: ssw.sw_2stream_bwd(*a),
                      lambda a: ssw.sw_2stream_bwd_plain(*a), sw_args,
                      f"{csrc}/solver_sw_bwd.cu",
                      f"{pallas}/solver_sw_bwd.py:402", work_sw),
    ]


def adjoint_report(prob, reports):
    """Phase 3, the resources of the adjoint kernels that keep their state
    in device memory or registers (rows 16, 17; rows 14 and 15 hold their
    state on chip: onchip_report) at the main path's shapes: ptxas
    registers and spills of each instantiation, resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, from the kernels' own
    libraries) and the device scratch of one launch."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs)
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw as flw
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_sw as fsw
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
             fsw.sw_fused_bwd_scratch_bytes(ncol, nlay, ngs))):
        rep = reports.get(name)
        regs = ("not rebuilt in this run" if rep is None else ", ".join(
            f"{r} registers, {ss} B spill stores, {sl} B spill loads"
            for r, ss, sl in ptxas_usage(rep)))
        log(f"adjoint {name}: ptxas {regs}; {blocks} resident blocks per SM"
            f" at {ncol} x {nlay}; scratch {scratch} B "
            f"({scratch / 1e9:.3f} GB)")
    del xl, xs


def tallest_column(kernel, ngpt, nband=0, nminor=0, **variant):
    """The tallest column ``kernel`` (of the solver_lw ``variant``) holds
    on chip at ngpt g-points, from onchip_geometry's message."""
    from rte_rrtmgp_tpu_torch.ops.kernels.onchip import onchip_geometry
    try:
        onchip_geometry(kernel, 10 ** 6, ngpt, nband, nminor, **variant)
    except ValueError as e:
        return int(str(e).split("at most ")[1].split()[0])
    raise SystemExit(f"{kernel}: no column-height limit")


def onchip_report(prob, reports):
    """Phase 3, the resources of the kernels that hold their transport on
    chip (rows 2, 3, 7, 8, 9, 10, 11, 12, 13, 14 and 15) at the main
    path's shapes, broadband and by band: ptxas registers and spills,
    shared memory per block (ops/kernels/onchip.py::onchip_geometry, and
    the launchers' own count beside it) and cluster size (row 14's blocks
    launch without a cluster), the tallest column, resident blocks per SM
    and clusters the card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    cudaOccupancyMaxActiveClusters), and device scratch. solver_lw
    is one kernel of nine instantiations: plain and rescaled, each with
    and without the Jacobian, broadband (rows 7 and 10) and by band (row
    7), and PFRAC (row 11); solver_sw one of two: the plain one of rows 9
    and 12 (broadband and by band) and the COMBINED one of row 13; ptxas
    lists them all. Then the minor, Rayleigh and major gathers' (rows 5, 6
    and 4) ptxas lines and resident blocks per SM at the path's widths,
    each launcher starting that many blocks per SM."""
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     allsky_sw_inputs)
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw as flw
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_sw as fsw
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (
        gas_minor_occupancy, gas_rayleigh_occupancy)
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw as slw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_2str as l2
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw as ss
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import (
        gas_major_occupancy)
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_bwd as lwb
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw_bwd as ssw
    from rte_rrtmgp_tpu_torch.ops.kernels._build import (library,
                                                         ptxas_usage)
    inp = prob.inputs
    ncol, nlay = inp.play.shape
    xs = allsky_sw_inputs(inp, prob.gas_sw, cloud_optics=prob.cld_sw)
    xl = allsky_lw_inputs(inp, prob.gas_lw, cloud_optics=prob.cld_lw)
    ngl, nbl = prob.gas_lw.ngpt, prob.gas_lw.grid.nband
    ngs, nbs = prob.gas_sw.ngpt, prob.gas_sw.grid.nband
    nminor = len(xs.minors)
    for name, nband, what in (
            ("fused_lw", 0, ""), ("fused_lw", nbl, ""),
            ("fused_sw", 0, ""), ("fused_sw", xs.nband, ""),
            ("solver_lw", 0, " (rows 7, 10)"), ("solver_lw", nbl, " (row 7)"),
            ("solver_lw", 0, " rescaled + Jacobian (rows 7, 10)"),
            ("solver_lw", nbl, " rescaled + Jacobian (row 7)"),
            ("solver_lw", 0, " PFRAC (row 11)"),
            ("solver_lw_2str", 0, ""), ("solver_lw_2str", nbl, ""),
            ("solver_sw", 0, " (rows 9, 12)"), ("solver_sw", nbs, " (row 9)"),
            ("solver_sw", 0, " COMBINED (row 13)"),
            ("solver_sw_bwd", 0, " (row 15)"),
            ("solver_lw_bwd", 0, " (row 14)")):
        if name == "fused_lw":
            x = xl._replace(byband=nband > 0)
            geo, occ = flw.lw_fused_geometry(x), flw.lw_fused_occupancy(x)
            smem_c = library(name).smem_fused_lw(nlay, geo.chunk,
                                                 len(xl.minors), nband)
            scratch = flw.lw_fused_scratch_bytes(ncol, nlay, ngl)
            top = tallest_column("fused_lw", ngl, nband, len(xl.minors))
        elif name == "fused_sw":
            x = xs._replace(byband=nband > 0, nband=nband)
            geo, occ = fsw.sw_fused_geometry(x), fsw.sw_fused_occupancy(x)
            smem_c = library(name).smem_fused_sw(nlay, geo.chunk, nminor,
                                                 nband)
            scratch = fsw.sw_fused_scratch_bytes(ncol, nlay,
                                                 xs.kmajor.shape[3])
            top = tallest_column("fused_sw", ngs, nband, nminor)
        elif name == "solver_lw":
            v = dict(rescale="rescaled" in what, jacobian="Jacobian" in what,
                     pfrac="PFRAC" in what)
            geo = slw.lw_noscat_geometry(nlay, ngl, nband, **v)
            occ = slw.lw_noscat_occupancy(nlay, ngl, nband, **v)
            smem_c = library(name).smem_solver_lw(
                nlay, geo.chunk, nband, *(int(x) for x in v.values()))
            scratch = slw.lw_noscat_scratch_bytes(ncol, nlay, ngl)
            top = tallest_column("solver_lw", ngl, nband, **v)
        elif name == "solver_lw_2str":
            geo = l2.lw_2stream_geometry(nlay, ngl, nband)
            occ = l2.lw_2stream_occupancy(nlay, ngl, nband)
            smem_c = library(name).smem_solver_lw_2str(nlay, geo.chunk, nband)
            scratch = l2.lw_2stream_scratch_bytes(ncol, nlay, ngl)
            top = tallest_column("lw_2stream", ngl, nband)
        elif name == "solver_sw":
            geo = ss.sw_2stream_geometry(nlay, ngs, nband)
            occ = ss.sw_2stream_occupancy(nlay, ngs, nband,
                                          combined="COMBINED" in what)
            smem_c = library(name).smem_solver_sw(nlay, geo.chunk, nband)
            scratch = ss.sw_2stream_scratch_bytes(ncol, nlay, ngs)
            top = tallest_column("solver_sw", ngs, nband)
        elif name == "solver_lw_bwd":
            geo = lwb.lw_noscat_bwd_geometry(nlay, ngl)
            occ = (lwb.lw_noscat_bwd_occupancy(nlay, ngl), None)
            smem_c = library(name).smem_solver_lw_bwd(nlay, geo.chunk)
            scratch = lwb.lw_noscat_bwd_scratch_bytes(ncol, nlay, ngl)
            top = tallest_column("solver_lw_bwd", ngl)
        else:
            geo = ssw.sw_2stream_bwd_geometry(nlay, ngs)
            occ = ssw.sw_2stream_bwd_occupancy(nlay, ngs)
            smem_c = library(name).smem_solver_sw_bwd(nlay, geo.chunk)
            scratch = ssw.sw_2stream_bwd_scratch_bytes(ncol, nlay, ngs)
            top = tallest_column("solver_sw_bwd", ngs)
        rep = reports.get(name)
        regs = ("not rebuilt in this run" if rep is None else ", ".join(
            f"{r} registers, {ss_} B spill stores, {sl} B spill loads"
            for r, ss_, sl in ptxas_usage(rep)))
        blocks = (f"cluster of {geo.nchunk}" if occ[1] is not None else
                  f"{geo.nchunk} independent")
        clusters = (f", {occ[1]} clusters at once" if occ[1] is not None
                    else "")
        log(f"on chip {name}{what} {'by band' if nband else 'broadband'}: "
            f"ptxas {regs}; chunk {geo.chunk} g-points, {blocks} blocks of "
            f"{geo.threads} threads, {geo.smem} B shared memory per block, "
            f"the tallest column {top} layers; {occ[0]} resident blocks per "
            f"SM{clusters}; scratch {scratch} B at {ncol} x {nlay}; the "
            f"launcher counts {smem_c} B of shared memory")
    rep = reports.get("gas_minor")
    regs = ("not rebuilt in this run" if rep is None else ", ".join(
        f"{r} registers, {ss_} B spill stores, {sl} B spill loads"
        for r, ss_, sl in ptxas_usage(rep)))
    for tag, gas in (("LW", prob.gas_lw), ("SW", prob.gas_sw)):
        kd = gas.kdist
        for atm, n in (("lower", len(kd.minor_lower)),
                       ("upper", len(kd.minor_upper))):
            blocks = gas_minor_occupancy(gas.ngpt, n)
            log(f"gas_minor {tag} {atm} ({gas.ngpt} g-points, {n} minors): "
                f"{blocks} resident blocks per SM")
    blocks = gas_rayleigh_occupancy(prob.gas_sw.ngpt)
    log(f"gas_rayleigh SW ({prob.gas_sw.ngpt} g-points): {blocks} resident "
        "blocks per SM")
    log(f"gas_minor: ptxas {regs} (the gas_minor_kernel and "
        "gas_rayleigh_kernel instantiations)")
    rep = reports.get("gas_major")
    regs = ("not rebuilt in this run" if rep is None else ", ".join(
        f"{r} registers, {ss_} B spill stores, {sl} B spill loads"
        for r, ss_, sl in ptxas_usage(rep)))
    for tag, ngpt, planck in (("LW", ngl, True), ("SW", ngs, False),
                              ("LW non-banded", 192, True)):
        blocks = gas_major_occupancy(ngpt, planck)
        log(f"gas_major {tag} ({ngpt} g-points"
            f"{', Planck fraction' if planck else ''}): {blocks} resident "
            "blocks per SM")
    log(f"gas_major: ptxas {regs} (its instantiations with and without the "
        "Planck fraction, of 256 and 1024 threads)")
    del xs, xl


def train(step, inputs):
    """One gradient step of a path: the benchmark's loss of its fluxes
    (torch_bench/steps/grad.py) and its gradients with respect to tlay,
    tsfc, lwp, rel and the water vapour."""
    import torch
    from torch_bench.steps.grad import loss_of
    ncol, nlay = inputs.play.shape
    leaves = {k: getattr(inputs, k).detach().clone().requires_grad_()
              for k in ("tlay", "tsfc", "lwp", "rel")}
    h2o = inputs.gas_concs.get_vmr("h2o", ncol, nlay).detach().clone() \
        .requires_grad_()
    out = step(inputs._replace(
        gas_concs=inputs.gas_concs.set_vmr("h2o", h2o), **leaves))
    return torch.autograd.grad(loss_of(out), tuple(leaves.values()) + (h2o,))


def composed(prob, path, **opts):
    """One all-sky step composed from the problem's objects through the
    fused step ("step"), the public API ("api") or the staged lane-layout
    branch ("staged"), or ("two-stream") the LW two-stream path:
    rte_lw with use_2stream on :func:`two_stream_optics`."""
    from rte_rrtmgp_tpu_torch.drivers import allsky
    from rte_rrtmgp_tpu_torch.rte import rte_lw

    def two_stream(i):
        f = rte_lw(*two_stream_optics(prob, i), i.sfc_emis,
                   use_2stream=True, **opts)
        return f.flux_up, f.flux_dn

    def step(i):
        lw, sw = (getattr(allsky, f"allsky_{path}_{b}")(
            i, getattr(prob, f"gas_{b}"), cloud_optics=getattr(
                prob, f"cld_{b}"), aerosol_optics=getattr(prob, f"aer_{b}"),
            **opts) for b in ("lw", "sw"))
        return (lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn,
                sw.flux_dn_dir)
    return two_stream if path == "two-stream" else step


def path_launches(dev, rf):
    """Phase 4, each path the cuda tests hold, run once at the main shapes
    with the kernels' launch counters set to 0 just before it (RFMIP at
    1800 x 61; the pod-scale loop over 4 chunks of 4096 x 72, resident and
    streamed, each with its untimed first step): path -> kernel ->
    launches, the kernels it launched. Nothing is gated here: the tests
    test_paths_launch_and_agree_at_main_shapes,
    test_gradient_step_launches_adjoints, test_rfmip_routes_on_card and
    test_podscale_streamed_equals_resident assert these counts."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers import rfmip
    from rte_rrtmgp_tpu_torch.drivers.allsky import (build_allsky,
                                                     build_allsky_step)
    from rte_rrtmgp_tpu_torch.models.ssm import (ssm_lw_defaults,
                                                 ssm_sw_defaults)
    from rte_rrtmgp_tpu_torch.ops.kernels import (
        aerosol_props, cloud_props, fused_lw, fused_sw, gas_descriptors,
        gas_major,
        gas_minor, minor_scale, solver_lanes, solver_lw, solver_lw_2str,
        solver_lw_bwd, solver_sw, solver_sw_bwd)
    from rte_rrtmgp_tpu_torch.parallel.scaling import _podscale
    counters = dict(
        cloud_props=cloud_props.cloud_props, fused_lw=fused_lw.lw_fused,
        fused_sw=fused_sw.sw_fused, gas_major=gas_major.gas_major,
        gas_minor=gas_minor.gas_minor, gas_rayleigh=gas_minor.gas_rayleigh,
        solver_lw=solver_lw.lw_noscat, solver_sw=solver_sw.sw_2stream,
        solver_lw_lanes=solver_lanes.lw_noscat_lanes,
        solver_lw_pfrac=solver_lanes.lw_noscat_lanes_pfrac,
        solver_sw_lanes=solver_lanes.sw_2stream_lanes,
        solver_sw_combined=solver_lanes.sw_2stream_lanes_combined,
        solver_lw_2str=solver_lw_2str.lw_2stream,
        fused_lw_bwd=fused_lw.lw_fused_bwd, fused_sw_bwd=fused_sw.sw_fused_bwd,
        solver_lw_bwd=solver_lw_bwd.lw_noscat_bwd,
        solver_sw_bwd=solver_sw_bwd.sw_2stream_bwd,
        minor_scale=minor_scale.minor_scale,
        minor_scale_bwd=minor_scale.minor_scale_bwd,
        gas_descriptors=gas_descriptors.gas_descriptors,
        gas_descriptors_bwd=gas_descriptors.gas_descriptors_bwd,
        aerosol_props=aerosol_props.aerosol_props)
    step, inputs = build_allsky_step(**MAIN, device=dev)
    prob = build_allsky(**MAIN, device=dev, use_aerosols=True)
    nb = build_allsky(**NONBANDED, device=dev, use_aerosols=True)
    nb_step = build_allsky_step(**NONBANDED, device=dev)[0]
    aer_step = build_allsky_step(**MAIN, device=dev, use_aerosols=True)[0]
    clear_step = build_allsky_step(**MAIN, device=dev, use_clouds=False)[0]
    aer, clear = dict(use_aerosols=True), dict(use_clouds=False)
    data, g_lw, g_sw = rf
    x = rfmip._inputs(data, g_lw)
    rf_lw = rfmip._lw_compute(g_lw, True, False, 1)
    rf_sw = rfmip._sw_compute(g_sw, True, False)
    s_lw, s_sw = ssm_lw_defaults(device=dev), ssm_sw_defaults(device=dev)
    pod = dict(chunk_cols_per_device=MAIN["ncol"], reps_per_chunk=1,
               host_pool=3, verbose=False, device=dev,
               **{k: MAIN[k] for k in ("ngpt_lw", "nbnd_lw", "ngpt_sw",
                                       "nbnd_sw", "ntemp", "npres")})
    paths = {
        "fused": lambda: step(inputs),
        "public API": lambda: composed(prob, "api")(inputs),
        "staged": lambda: composed(prob, "staged")(inputs),
        "fused by band": lambda: composed(prob, "step", byband=True)(inputs),
        "two-stream": lambda: composed(prob, "two-stream")(inputs),
        "two-stream by band": lambda: composed(prob, "two-stream",
                                               byband=True)(inputs),
        "fused non-banded": lambda: nb_step(nb.inputs),
        "staged non-banded": lambda: composed(nb, "staged")(nb.inputs),
        "aerosols fused": lambda: aer_step(inputs),
        "aerosols staged": lambda: composed(prob, "staged", **aer)(inputs),
        "aerosols public API": lambda: composed(prob, "api", **aer)(inputs),
        "clear-sky fused": lambda: clear_step(inputs),
        "clear-sky staged": lambda: composed(prob, "staged",
                                             **clear)(inputs),
        "fused training step": lambda: train(step, inputs),
        "aerosols fused training step": lambda: train(aer_step, inputs),
        "public API training step": lambda: train(composed(prob, "api"),
                                                  inputs),
        "rfmip": lambda: rfmip.rfmip_lw_sw(data, g_lw, g_sw),
        "rfmip generic route": lambda: (rf_lw(*rfmip._lw_args(x))
                                        + rf_sw(*rfmip._sw_args(x))),
        "rfmip ssm": lambda: rfmip.rfmip_lw_sw(data, s_lw, s_sw),
        "podscale resident": lambda: _podscale(
            4 * MAIN["ncol"], MAIN["nlay"], stream=False, **pod),
        "podscale streamed": lambda: _podscale(
            4 * MAIN["ncol"], MAIN["nlay"], stream=True, **pod)}
    out = {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        fn()
        torch.cuda.synchronize()
        out[name] = {k: c.launches for k, c in counters.items()
                     if c.launches}
        log(f"{name} launches: {out[name]}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from rte_rrtmgp_tpu_torch.drivers.allsky import build_allsky
    from rte_rrtmgp_tpu_torch.ops.kernels import _build

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
    rows = (fused_rows(prob, dev, variants) + scale_rows(prob, variants)
            + descriptor_rows(prob, variants) + aerosol_rows(prob, variants)
            + api_rows(prob, dev, variants)
            + lw2_rows(prob, dev, variants) + lanes_rows(prob, nonbanded))
    del nonbanded
    torch.cuda.empty_cache()
    rows += adjoint_rows(prob, dev, variants)
    adjoint_report(prob, reports)
    onchip_report(prob, reports)
    del prob
    torch.cuda.empty_cache()
    rf = rfmip_problem(dev)
    rfmip_rows(rf, dev, variants)
    log(f"variants checked against their twins: "
        f"{', '.join(v['name'] for v in variants)}")

    # ---- 4. each path's launches; a row's are those of the first path
    # that launches its kernel ----
    paths = path_launches(dev, rf)
    del rf
    torch.cuda.empty_cache()
    for row in rows:
        row["launches"] = next((n[row["name"]] for n in paths.values()
                                if row["name"] in n), None)

    # ---- 5. result ----
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows, "paths": paths}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
