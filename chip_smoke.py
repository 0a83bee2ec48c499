#!/usr/bin/env python3
"""Run the PyTorch port's three all-sky paths, the LW two-stream path,
gradient steps through two of them, the RFMIP driver (its fused and
generic routes and SSM) and the pod-scale stream on one CUDA GPU and
check them.

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
     work (the LW no-scattering solver as the public path calls it: one
     scalar secant, no rescaling, no Jacobian; the minor and Rayleigh
     gathers out of place, as the gas optics call them); the four adjoint
     kernels against the twins' autograd on the same inputs and seeded
     flux cotangents (see TOL_ADJ); then the variants the paths can ask
     for, each against its twin and timed, logged but not in the kernels
     line: by-band output of the fused LW and SW steps and of the LW
     no-scattering, LW two-stream and SW solvers, the LW no-scattering
     solver with Tang rescaling, the Jacobian and a secant field (also by
     band), the Rayleigh gather's split variant (0 + Rayleigh, no ssa),
     the fused steps with an incident flux (LW) and a diffuse one (SW),
     and their adjoints with the same; for the adjoints of rows 16 and 17
     their ptxas registers and spills, resident blocks per SM and scratch
     bytes; for the kernels that hold their transport on chip (fused_lw,
     fused_sw, solver_lw in its variants, solver_lw_2str, the SW solver's
     plain and COMBINED instantiations and the adjoints solver_sw_bwd and
     solver_lw_bwd) the same and their shared memory per block, cluster
     size and tallest column, broadband and by band; the minor, Rayleigh
     and major gathers' resident blocks per SM; the tallest column the
     fused LW step, the LW no-scattering solver (as the public path calls
     it, and rescaled with the Jacobian) and its adjoint, the SW solver
     and its adjoint hold, against their twins, and one layer more
     raising ValueError; the fused LW and SW steps on the RFMIP driver's
     inputs at 1800 x 61 (100 sites x 18 experiments; the SW direct
     incident flux scaled to each column's TSI, drawn from a fixed seed,
     mu0 = 1 on the night columns) and the LW and SW solvers at SSM's 41
     g-points on the same profiles, as variants;
  4. golden gates at the production configuration (256 x 72): the float32
     fused step, public-API path and staged path against
     tests/golden/production.npz, and the float32 aerosols step (fused)
     against the port's float64 twin of that step on the CPU, each field
     within 3x tests/golden/production_f32_noise.json; the fused path's
     d(TOA LW up)/d(tsfc) against the analytic surface Jacobian, and the
     float32 training-loss gradients against the float64 twin's on the
     CPU (printed as the gradient noise floor); the float32 LW two-stream
     path against the port's float64 twin of it on the CPU (no two-stream
     golden is committed), within the same 3x noise floor; the float32
     RFMIP driver at the golden's shape (6 x 20 x 3, 32 g-points) against
     tests/golden/rfmip.npz, each field within 3x the distance of the
     port's float32 twin of it on the CPU, measured in the same run;
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
     aerosols fused and two-stream paths: device time by kernel, each
     hand-written kernel on a line of its own, device busy share) and the
     peak device memory of the fused and two-stream
     steps; then two gradient steps
     (forward + backward of a weighted flux loss) on the fused path with
     clouds, then with aerosols, and on the public-API path, with the
     adjoint kernels each launched once per step, gradients finite and
     bit-identical over the two, the step time beside the forward's, the
     fused step's peak device memory and its profile; the RFMIP driver
     at 1800 x 61 (rfmip_lw_sw): fused_lw and fused_sw once per step and
     nothing else, finite non-negative fluxes, night columns zero, TOA SW
     down = TSI mu0 by day, against its generic route (the gathers and
     the public solvers) within rtol 3e-5 / atol 5e-4 W/m2, blocked (100
     columns a block) against one launch, its median step with the host
     readback and chained on the device, and a profile; RFMIP through SSM
     (solver_lw and solver_sw once per step) and its step; the pod-scale
     configuration, 1,000,000 columns resident and 100,000 streamed in
     chunks of 4096 x 72, columns/s of each, cloud_props twice and the
     fused steps once per chunk, the streamed run's last chunk bit for
     bit the resident run's and the fused step's;
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
# bench.py's rfmip configuration (:171-255): 100 sites x 18 experiments x
# 61 layers through the RFMIP drivers, LW 256 / 16, SW 224 / 14; each
# column's TSI drawn from seed 5 in [1300, 1420] W/m2
RFMIP = dict(nsite=100, nlay=61, nexp=18)
RFMIP_TSI = (5, 1300.0, 1420.0)
# the RFMIP golden's case (tests/test_golden_regression.py:25-37)
RFMIP_GOLDEN = dict(nsite=6, nlay=20, nexp=3)
RFMIP_GOLDEN_KD = dict(ngpt=32, nbnd=4, ntemp=6, npres=12)
CHAINED = 10              # steps per chained window (bench.py BENCH_INNER)
# bench.py's podscale configuration (:258-305): 1,000,000 columns
# resident, then a tenth of them streamed, in chunks of 4096 x 72
PODSCALE_COLS, PODSCALE_STREAMED = 1_000_000, 100_000
# the streamed run's distinct host chunks: 3 against 2 device buffers, so
# that a chunk read from the wrong buffer is another chunk's data (25
# chunks: the last is entry 0, the resident chunk)
PODSCALE_POOL = 3
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
OPS_RAYLEIGH_SPLIT = 16    # 2-D lerp (14), x scale, 0 + it
OPS_SCALE = 5              # per (window, cell): density, fraction, mask
OPS_SCALE_BWD = 12         # per (window, cell): the scaling's adjoint
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
# the minor-scaling adjoint against the float64 twin's autograd: each
# cotangent within this share of its largest value (float32 rounding of
# a few products per window and cell)
TOL_SCALE_ADJ = 1e-5
# the gas descriptors per cell: the column amounts (a product per gas, the
# dry column's 12), the temperature and pressure coefficients (12, a log),
# and per flavor and temperature corner the mix, eta and its split (8);
# the adjoint: per flavor and corner 12, per gas 3, the cell's terms 16
OPS_DESC_CELL = 24
OPS_DESC_FLAVOR = 8
OPS_DESC_BWD_CELL = 16
OPS_DESC_BWD_FLAVOR = 12
# the descriptors' adjoint against the float64 twin's autograd: each
# cotangent within this share of its largest value
TOL_DESC_ADJ = 1e-6


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


def bound(moved_bytes, ops):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is larger."""
    t_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
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


def fused_ops(lw, sw, ncell):
    """The operations of the fused LW and SW steps on ``ncell`` cells."""
    gpt = lambda x: sum(w for (_, _, _, w, _) in x.minors)
    ngl, ngs = lw.kmajor.shape[3], sw.kmajor.shape[3]
    ops_lw = ncell * (ngl * (8 * (OPS_MAJOR_CORNER + OPS_PFRAC_CORNER)
                             + OPS_PLANCK + OPS_LW_LAYER)
                      + gpt(lw) * OPS_MINOR)
    ops_sw = ncell * (ngs * (8 * OPS_MAJOR_CORNER + OPS_RAYLEIGH
                             + OPS_SW_COMBINE + OPS_SW_LAYER)
                      + gpt(sw) * OPS_MINOR)
    return ops_lw, ops_sw


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
    ops_lw, ops_sw = fused_ops(lw, sw, ncell)
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


def scale_rows(prob, variants):
    """Phase 3, the minor-gas scaling rows of every window in one launch
    (csrc/minor_scale.cu; no TPU kernel: the JAX package forms them in
    plain JAX, rte_rrtmgp_tpu/ops/gas_optics.py:297-309) and their
    adjoint, LW and SW, on the layer-major views the fused gas optics hand
    over (play.T, col_gas.transpose(1, 2)): the rows bit for bit the
    twin's (the per-window loop), the adjoint's cotangents within
    TOL_SCALE_ADJ of the float64 twin's autograd on seeded cotangents and
    the same bits twice; each timed beside its twin (the loop; the
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
        if not torch.equal(minor_scale(*args), minor_scale_plain(*args)):
            raise SystemExit(f"minor_scale {band}: rows not bit for bit "
                             "the twin's")
        gen = torch.Generator(device=tropo.device).manual_seed(9)
        g = torch.randn((nwin,) + tuple(tropo.shape), generator=gen,
                        device=tropo.device)
        got = minor_scale_bwd(*args, g)
        if not all(map(torch.equal, got, minor_scale_bwd(*args, g))):
            raise SystemExit(f"minor_scale_bwd {band}: two runs differ")

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
            if not (bool(torch.isfinite(a).all())
                    and errs[-1] <= TOL_SCALE_ADJ * scale):
                raise SystemExit(f"minor_scale_bwd {band}: {name} cotangent "
                                 "disagrees with the twin")
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
    fused layout (layer-major outputs) and the public one: every output
    bit for bit the twin's (ops/gas_optics.py::column_amounts and
    interpolation), the adjoint's cotangents of play, tlay, plev and the
    water vapour within TOL_DESC_ADJ of the float64 twin's autograd on
    seeded cotangents and the same bits twice; each timed beside its twin,
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
            got, ref = gas_descriptors(*args), gas_descriptors_plain(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("col_gas",) + tuple(got[1]._fields),
                                  (got[0], *got[1]), (ref[0], *ref[1])):
                bits = (lambda x: x.view(torch.int32)
                        if x.dtype == torch.float32 else x)
                if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
                    raise SystemExit(f"gas_descriptors {band} {layout}: "
                                     f"{name} not bit for bit the twin's")
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
            log(f"kernel {label}: bit for bit the twin's (col_gas and "
                "every coefficient)")
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
                again = gas_descriptors_bwd(*bargs)
            flat = lambda r: (r[0], r[1], r[2], r[4][h2o - 1])
            dg, again = flat(dg), flat(again)
            if not all(map(torch.equal, dg, again)):
                raise SystemExit(f"{label} adjoint: two runs differ")

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
                if not (bool(torch.isfinite(a).all())
                        and errs[-1] <= TOL_DESC_ADJ):
                    raise SystemExit(f"{label} adjoint: {name} cotangent "
                                     "disagrees with the twin")
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
            del got, ref, g, dg, again, bargs
    torch.cuda.empty_cache()
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
    # the kernel gathers from the interleaved table the gas optics hold;
    # the function's inputs are the descriptors and the two tables
    major = (co, kd.kmajor, kd.planck_frac, gl.gpoint_flavor,
             gl.kmajor_pfrac)
    rows = [check_kernel(
        "gas_major", lambda a: gas_major(*a), lambda a: gas_major_plain(*a),
        major, TOL_GATHER, "rte_rrtmgp_tpu_torch/csrc/gas_major.cu",
        "rte_rrtmgp_tpu/ops/pallas/major_gather.py:188",
        (nbytes(major[:4]) + 2 * ncell * ngl * 4,
         ncell * ngl * 8 * (OPS_MAJOR_CORNER + OPS_PFRAC_CORNER)))]

    tau = gas_major_plain(*major)[0]
    lo = _split_minors(gl.minors)[0]
    scaling = minor_scaling(co, kd.minor_lower, lower=True, play=inp.play,
                            tlay=inp.tlay, col_gas=col_gas, idx_h2o=idx_h2o)
    minor = (tau, co, kd.kminor_lower, lo, gl.minor_meta[:len(lo)], scaling)
    covered = sum(w for (_, _, w, _) in lo)
    # out of place, as the gas optics call it (models/rrtmgp/gas_optics.py
    # ::_minor): tau read, a new tensor written
    rows.append(check_kernel(
        "gas_minor", lambda a: gas_minor(*a, out=torch.empty_like(a[0])),
        lambda a: gas_minor_plain(*a, out=torch.empty_like(a[0])),
        minor, TOL_GATHER, "rte_rrtmgp_tpu_torch/csrc/gas_minor.cu",
        "rte_rrtmgp_tpu/ops/pallas/minor_gather.py:100",
        (nbytes(co.jtemp, co.ftemp, co.jeta, co.feta, kd.kminor_lower,
                scaling) + 2 * tau.numel() * 4,
         ncell * covered * OPS_MINOR)))
    del minor, tau, scaling

    co, col_gas, col_dry, idx_h2o = cells(gs)
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
        (descr + 3 * tau.numel() * 4, ncell * ngs * OPS_RAYLEIGH)))
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
         ncol * nlay * ngl * OPS_LW_LAYER)))
    resc = (props.tau, src.lay_source, src.lev_source, rand(bc, 0.8, 1.0),
            src.sfc_source, rand(bc, 0.0, 2.0),
            dict(ds=gl.compute_optimal_angles(props), weight=1.0,
                 sfc_src_jac=src.sfc_source_jac, ssa=rand(shape, 0.0, 0.6),
                 g=rand(shape, 0.0, 0.9)))
    nbl = gl.grid.nband
    bands = dict(gpt2band=gl.gpt2band, nband=nbl)
    for name, x, nout, ops in (
            ("solver_lw byband", path[:6] + (dict(path[6], **bands),),
             2 * nbl, OPS_LW_LAYER),
            ("solver_lw rescaled", resc, 3, OPS_LW_LAYER + OPS_LW_RESCALE),
            ("solver_lw rescaled byband", resc[:6] + (dict(resc[6], **bands),),
             2 * nbl + 1, OPS_LW_LAYER + OPS_LW_RESCALE)):
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
    ops_lw, ops_sw = fused_ops(lw, sw, ncol * nlay)
    variants.append(check_kernel(
        "fused_lw rfmip", lw_fused, lw_fused_plain, lw, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/fused_lw.cu",
        "rte_rrtmgp_tpu/ops/pallas/fused_lw.py:368",
        (nbytes(tuple(lw)) + 2 * nlev * ncol * 4, ops_lw)))
    variants.append(check_kernel(
        "fused_sw rfmip tsi", sw_fused, sw_fused_plain, sw, TOL_FLUX,
        "rte_rrtmgp_tpu_torch/csrc/fused_sw.cu",
        "rte_rrtmgp_tpu/ops/pallas/fused_sw.py:309",
        (nbytes(tuple(sw)) + 3 * nlev * ncol * 4, ops_sw)))
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
        (nbytes(path) + 2 * ncol * nlev * 4, ncol * nlay * ngpt * OPS_LW_LAYER)))
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
        (nbytes(args) + 3 * ncol * nlev * 4, ncol * nlay * ngpt * OPS_SW_LAYER)))


def rfmip_gate(dev):
    """Phase 4, the float32 RFMIP driver (its fused route) on the card at
    the golden's shape against tests/golden/rfmip.npz: each field within
    3x the distance of the port's float32 twin of the same driver on the
    CPU from the same golden, measured in this run."""
    import numpy as np
    from rte_rrtmgp_tpu_torch.drivers.rfmip import (rfmip_lw, rfmip_sw,
                                                    synthetic_rfmip)
    from rte_rrtmgp_tpu_torch.models.rrtmgp.gas_optics import GasOpticsRRTMGP
    from rte_rrtmgp_tpu_torch.utils.synthetic import synthetic_kdist
    golden = np.load(os.path.join(HERE, "tests", "golden", "rfmip.npz"))

    def run(device):
        data = synthetic_rfmip(**RFMIP_GOLDEN)
        kd = dict(RFMIP_GOLDEN_KD, device=device)
        out = (rfmip_lw(data, GasOpticsRRTMGP(synthetic_kdist(sw=False, **kd)))
               + rfmip_sw(data, GasOpticsRRTMGP(synthetic_kdist(sw=True,
                                                                **kd))))
        return dict(zip(("lw_up", "lw_dn", "sw_up", "sw_dn"), out))

    card, twin = run(dev), run("cpu")
    for key, ref in golden.items():
        d = float(np.abs(card[key] - ref).max())
        t = float(np.abs(twin[key] - ref).max())
        log(f"golden rfmip {key}: max |f32 card - f64 golden| {d:.4g} "
            f"(limit {3 * t:.4g}: 3x the float32 twin's {t:.4g})")
        if not d <= 3 * t:
            raise SystemExit(f"golden gate failed on rfmip {key}")


def wall_ms(fn, inner=1):
    """Median over REPS of the wall time of ``inner`` calls of fn ending
    in one torch.cuda.synchronize(), per call, in ms."""
    import torch
    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / inner)
    return statistics.median(times) * 1e3


def counted(name, counters, fn, exact=None, launched=(), per=1):
    """fn() with the counters set to 0 just before it, and its launches
    divided by ``per`` (the steps fn takes): each kernel in ``exact``
    (name -> launches) launched so many times, each in ``launched`` at
    least once, no other. Returns (fn's result, the launches)."""
    import torch
    exact = exact or {}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: c.launches // per for k, c in counters.items()}
    log(f"{name} launches: {launches}")
    for k, n in launches.items():
        if k in exact and n != exact[k]:
            raise SystemExit(f"{name} launched {k} {n} times, expected "
                             f"{exact[k]}")
        if k in launched and n == 0:
            raise SystemExit(f"{name} never launched {k}")
        if k not in exact and k not in launched and n != 0:
            raise SystemExit(f"{name} launched {k}")
    return out, launches


def rfmip_paths(rf, dev, counters, card):
    """Phase 5, the RFMIP driver at 1800 x 61 through rfmip_lw_sw: fused_lw
    and fused_sw once per step and nothing else; finite non-negative
    fluxes, the night columns zero, TOA SW down = TSI mu0 by day; the
    host-readback result the device result; against the generic route
    (gathers and public solvers) within PATH_RTOL / PATH_ATOL; blocked
    (100 columns a block) against one launch within tests/test_rfmip.py's
    bounds; the median step with the host readback and chained on the
    device (bench.py's two lines), and a profile. Then RFMIP through SSM:
    solver_lw and solver_sw once per step, finite fluxes, its step."""
    import numpy as np
    import torch
    from rte_rrtmgp_tpu_torch.drivers import rfmip
    from rte_rrtmgp_tpu_torch.drivers.rfmip import rfmip_lw_sw
    from rte_rrtmgp_tpu_torch.models.ssm import (ssm_lw_defaults,
                                                 ssm_sw_defaults)
    data, g_lw, g_sw = rf
    ncol = data.ncol
    host, launches = counted(
        "rfmip", counters, lambda: rfmip_lw_sw(data, g_lw, g_sw),
        {"fused_lw": 1, "fused_sw": 1, "minor_scale": 2,
         "gas_descriptors": 2})
    out = rfmip_lw_sw(data, g_lw, g_sw, device_out=True)
    if not np.array_equal(out.cpu().numpy(), np.stack(host)):
        raise SystemExit("rfmip: the host readback differs from the "
                         "device result")
    if not bool(torch.isfinite(out).all()) or bool((out < 0).any()):
        raise SystemExit("rfmip fluxes not finite or negative")
    x = rfmip._inputs(data, g_lw)
    usecol, mu0 = rfmip._sun(x["sza"])
    if bool((out[2:, ~usecol] != 0).any()):
        raise SystemExit("rfmip: night columns not zero")
    toa = (x["tsi"] * mu0)[usecol].double()
    toa_err = float(((out[3, usecol, 0].double() - toa).abs() / toa).max())
    log(f"rfmip sw_dn at TOA vs TSI * mu0 on {int(usecol.sum())} day "
        f"columns: rel err {toa_err:.2e}")
    if toa_err > 1e-5:
        raise SystemExit("rfmip: sw_dn at TOA does not equal TSI * mu0")
    lw = rfmip._lw_compute(g_lw, True, False, 1)
    sw = rfmip._sw_compute(g_sw, True, False)
    gen, _ = counted(
        "rfmip generic route", counters,
        lambda: lw(*rfmip._lw_args(x)) + sw(*rfmip._sw_args(x)),
        {"gas_major": 2, "gas_minor": 4, "gas_rayleigh": 1, "solver_lw": 1,
         "solver_sw": 1, "minor_scale": 2, "gas_descriptors": 2})
    agree("rfmip generic route", gen, tuple(out))
    blk = rfmip_lw_sw(data, g_lw, g_sw, block_size=RFMIP["nsite"])
    diff = max(float(np.abs(a - b).max()) for a, b in zip(blk, host))
    log(f"rfmip blocked ({RFMIP['nsite']} columns a block) vs one launch: "
        f"max |diff| {diff:.3e} W/m2")
    for a, b in zip(blk, host):
        if not np.allclose(a, b, rtol=2e-6, atol=1e-5):
            raise SystemExit("rfmip: blocked and unblocked disagree")
    del out, gen, blk
    t_host = wall_ms(lambda: rfmip_lw_sw(data, g_lw, g_sw))
    t_chain = wall_ms(lambda: rfmip_lw_sw(data, g_lw, g_sw,
                                          device_out=True), CHAINED)
    log(f"rfmip step ({card}): {t_host:.3f} ms median of {REPS} with the "
        f"host readback ({ncol / t_host * 1e3:.1f} columns/s), "
        f"{t_chain:.3f} ms chained over {CHAINED} steps on the device "
        f"({ncol / t_chain * 1e3:.1f} columns/s)")
    profile_path("rfmip", lambda _: rfmip_lw_sw(data, g_lw, g_sw,
                                                 device_out=True), None)

    s_lw, s_sw = ssm_lw_defaults(device=dev), ssm_sw_defaults(device=dev)
    out, _ = counted("rfmip ssm", counters,
                     lambda: rfmip_lw_sw(data, s_lw, s_sw, device_out=True),
                     {"solver_lw": 1, "solver_sw": 1})
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("rfmip ssm fluxes not finite")
    t_ssm = wall_ms(lambda: rfmip_lw_sw(data, s_lw, s_sw))
    log(f"rfmip ssm step ({card}): {t_ssm:.3f} ms median of {REPS} with "
        f"the host readback ({ncol / t_ssm * 1e3:.1f} columns/s)")
    return launches


def podscale_paths(dev, counters, card):
    """Phase 5, the pod-scale configuration at bench.py's defaults:
    PODSCALE_COLS resident, then PODSCALE_STREAMED streamed, in chunks of
    4096 x 72: columns/s for each; cloud_props twice, fused_lw and
    fused_sw once per step (each chunk and the untimed first step). The
    streamed run cycles PODSCALE_POOL distinct host chunks through two
    device buffers, out of phase: each chunk's outputs bit for bit the
    fused step's on its pool entry, and the last chunk (entry 0) the
    resident run's."""
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import build_allsky_step
    from rte_rrtmgp_tpu_torch.parallel.scaling import _podscale, _pool_entry
    kw = dict(chunk_cols_per_device=MAIN["ncol"], reps_per_chunk=1,
              host_pool=PODSCALE_POOL, verbose=False, device=dev,
              **{k: MAIN[k] for k in ("ngpt_lw", "nbnd_lw", "ngpt_sw",
                                      "nbnd_sw", "ntemp", "npres")})
    outs = []
    for what, total, stream in (("resident", PODSCALE_COLS, False),
                                ("streamed", PODSCALE_STREAMED, True)):
        n = -(-total // MAIN["ncol"]) + 1
        (r, out), _ = counted(
            f"podscale {what}", counters,
            lambda: _podscale(total, MAIN["nlay"], stream=stream,
                              keep=stream, **kw),
            {"cloud_props": 2 * n, "fused_lw": n, "fused_sw": n,
             "minor_scale": 2 * n, "gas_descriptors": 2 * n})
        log(f"podscale {what} ({card}): {r['n_chunks']} chunks of "
            f"{r['chunk_columns']} x {MAIN['nlay']}, {r['total_columns']:,} "
            f"columns in {r['seconds']:.3f} s, {r['cols_per_s']:.1f} "
            "columns/s")
        outs.append(out)
    resident, streamed = outs
    if (len(streamed) - 1) % PODSCALE_POOL:
        raise SystemExit("podscale: the last streamed chunk is not pool "
                         "entry 0")
    step, inputs = build_allsky_step(**MAIN, device=dev)
    refs = []
    for j in range(PODSCALE_POOL):
        lw_up, _, sw_up, _, _ = step(_pool_entry(inputs, j))
        refs.append((lw_up[:, 0], sw_up[:, 0]))
    if any(torch.equal(a, b) for j in range(1, PODSCALE_POOL)
           for a, b in zip(refs[0], refs[j])):
        raise SystemExit("podscale: two pool entries give the same outputs")
    wrong = [k for k, out in enumerate(streamed)
             if not all(map(torch.equal, out, refs[k % PODSCALE_POOL]))]
    same = all(map(torch.equal, streamed[-1], resident[0]))
    log(f"podscale: {len(streamed) - len(wrong)} of {len(streamed)} "
        f"streamed chunks bit for bit the fused step's on their pool "
        f"entry; the last {'is' if same else 'is not'} bit for bit the "
        "resident run's")
    if wrong or not same:
        raise SystemExit(f"podscale: streamed chunks {wrong} differ from "
                         "their pool entries, or the last from the "
                         "resident run's")


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
        if blocks < 1:
            raise SystemExit(f"{name}: no block fits an SM ({blocks})")
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
    shared memory per block and cluster size (ops/kernels/onchip.py::
    onchip_geometry, held against the launchers' own count; row 14's
    blocks launch without a cluster), the tallest column, resident blocks
    per SM and clusters the card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    cudaOccupancyMaxActiveClusters), and device scratch (none). solver_lw
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
            f"SM{clusters}; scratch {scratch} B at {ncol} x {nlay}")
        if smem_c != geo.smem:
            raise SystemExit(f"{name}: onchip_geometry counts {geo.smem} B of"
                             f" shared memory, the launcher {smem_c}")
        if occ[0] < 1 or (occ[1] is not None and occ[1] < 1):
            raise SystemExit(f"{name}: no block or cluster fits ({occ})")
        if scratch != 0:
            raise SystemExit(f"{name}: {scratch} B of device scratch")
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
            if blocks < 1:
                raise SystemExit(f"gas_minor: no block fits an SM ({blocks})")
    blocks = gas_rayleigh_occupancy(prob.gas_sw.ngpt)
    log(f"gas_rayleigh SW ({prob.gas_sw.ngpt} g-points): {blocks} resident "
        "blocks per SM")
    if blocks < 1:
        raise SystemExit(f"gas_rayleigh: no block fits an SM ({blocks})")
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
        if blocks < 1:
            raise SystemExit(f"gas_major: no block fits an SM ({blocks})")
    log(f"gas_major: ptxas {regs} (its instantiations with and without the "
        "Planck fraction, of 256 and 1024 threads)")
    del xs, xl


def onchip_limits(dev):
    """Phase 3, the column-height limits of the fused LW step, the LW
    no-scattering solve (as the public path calls it, and rescaled with
    the Jacobian) and its adjoint, the SW solve and its adjoint on the
    card, at the
    flagship's 256 and 224 g-points (chunks of 32): the tallest column
    each holds (from onchip_geometry's message), 4 columns of the flagship
    problem (the fused LW step) or of seeded optics, against the twin
    (fluxes within TOL_FLUX of the
    largest twin flux; each cotangent within TOL_ADJ of its largest twin
    value, or, where the float32 twin itself misses that against the
    float64 twin, within TOL_ADJ of the float64 twin's: check_adjoint's
    rule); one layer more raises ValueError naming the limit and launches
    nothing. Then the adjoint's tallest column with mu0 up to the clamp at
    k mu0 = 1, where float32 resolves the ssa, g and mu0 cotangents in no
    implementation: there a cotangent that the float32 twin misses is held
    within TOL_COND times the twin's distance from the float64 twin."""
    import numpy as np
    import torch
    from rte_rrtmgp_tpu_torch.drivers.allsky import (allsky_lw_inputs,
                                                     build_allsky)
    from rte_rrtmgp_tpu_torch.ops.kernels import fused_lw as flw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw as slw
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_lw_bwd as lwb
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw as ss
    from rte_rrtmgp_tpu_torch.ops.kernels import solver_sw_bwd as ssw
    ncol, ngpt = 4, MAIN["ngpt_sw"]

    # the fused LW step on 4 columns of the flagship problem, as tall as
    # a block holds, with clouds and a non-zero incident flux
    lw_dims = dict(MAIN, ncol=ncol)
    p = build_allsky(**dict(lw_dims, nlay=8), device=dev)
    nminor = len(allsky_lw_inputs(p.inputs, p.gas_lw,
                                  use_clouds=False).minors)
    nlay = tallest_column("fused_lw", MAIN["ngpt_lw"], 0, nminor)
    for n in (nlay, nlay + 1):
        p = build_allsky(**dict(lw_dims, nlay=n), device=dev)
        x = allsky_lw_inputs(p.inputs, p.gas_lw, cloud_optics=p.cld_lw)
        x = x._replace(inc=0.5 + torch.rand(
            x.inc.shape, generator=torch.Generator(device=dev).manual_seed(
                22), device=dev))
        n0 = flw.lw_fused.launches
        if n == nlay:
            got, ref = flw.lw_fused(x), flw.lw_fused_plain(x)
            torch.cuda.synchronize()
            err = (max(float((g - r).abs().max()) for g, r in zip(got, ref))
                   / max(float(r.abs().max()) for r in ref))
            log(f"fused_lw: the tallest column, {n} layers at "
                f"{x.kmajor.shape[3]} g-points, against the twin: {err:.3e}"
                f" of the largest twin flux (limit {TOL_FLUX})")
            if not err <= TOL_FLUX or flw.lw_fused.launches != n0 + 1:
                raise SystemExit("fused_lw: the tallest column disagrees "
                                 "with the twin")
            continue
        try:
            flw.lw_fused(x)
        except ValueError as e:
            if f"at most {nlay} layers" not in str(e):
                raise
            log(f"fused_lw: {n} layers raise ValueError: {e}")
        else:
            raise SystemExit(f"fused_lw: {n} layers did not raise")
        if flw.lw_fused.launches != n0:
            raise SystemExit("fused_lw: launched past its limit")
    del p, x

    # the LW no-scattering solve as the public path calls it and rescaled
    # with the Jacobian and a secant field, at the flagship's 256
    # g-points, on 4 columns of seeded sources and optical depths from
    # 1e-6 to 10
    rng = np.random.default_rng(24)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(
        lo, hi, shape).astype(np.float32)).to(dev)
    ngl = MAIN["ngpt_lw"]
    for variant in (dict(), dict(rescale=True, jacobian=True)):
        nlay = tallest_column("solver_lw", ngl, **variant)
        for n in (nlay, nlay + 1):
            lay3 = (ncol, n, ngl)
            tau = torch.from_numpy((10.0 ** rng.uniform(-6.0, 1.0, lay3))
                                   .astype(np.float32)).to(dev)
            a = (tau, u(0.5, 1.5, *lay3), u(0.5, 1.5, ncol, n + 1, ngl),
                 u(0.8, 1.0, ncol, ngl), u(0.5, 1.5, ncol, ngl),
                 u(0.0, 0.5, ncol, ngl))
            kw = dict(ds=1.66, weight=0.5)
            if variant:
                kw.update(ds=u(1.0, 2.0, ncol, ngl), sfc_src_jac=u(
                    0.0, 0.1, ncol, ngl), ssa=u(0.0, 0.6, *lay3),
                    g=u(0.0, 0.9, *lay3))
            what = "rescaled + Jacobian" if variant else "path"
            n0 = slw.lw_noscat.launches
            if n == nlay:
                got = as_tuple(slw.lw_noscat(*a, **kw))
                ref = as_tuple(slw.lw_noscat_plain(*a, **kw))
                torch.cuda.synchronize()
                err = (max(float((g - r).abs().max())
                           for g, r in zip(got, ref))
                       / max(float(r.abs().max()) for r in ref))
                log(f"solver_lw {what}: the tallest column, {n} layers at "
                    f"{ngl} g-points, against the twin: {err:.3e} of the "
                    f"largest twin flux (limit {TOL_FLUX})")
                if not err <= TOL_FLUX or slw.lw_noscat.launches != n0 + 1:
                    raise SystemExit(f"solver_lw {what}: the tallest column "
                                     "disagrees with the twin")
                continue
            try:
                slw.lw_noscat(*a, **kw)
            except ValueError as e:
                if f"at most {nlay} layers" not in str(e):
                    raise
                log(f"solver_lw {what}: {n} layers raise ValueError: {e}")
            else:
                raise SystemExit(f"solver_lw {what}: {n} layers did not "
                                 "raise")
            if slw.lw_noscat.launches != n0:
                raise SystemExit("solver_lw: launched past its limit")
    del a, tau

    # its adjoint (row 14) at the flagship's 256 g-points, as rte_lw's
    # gradient calls it, on 4 columns of seeded sources, flux cotangents
    # and optical depths from 1e-6 to 10
    nlay = tallest_column("solver_lw_bwd", ngl)
    for n in (nlay, nlay + 1):
        lay3 = (ncol, n, ngl)
        tau = torch.from_numpy((10.0 ** rng.uniform(-6.0, 1.0, lay3))
                               .astype(np.float32)).to(dev)
        a = (tau, u(0.5, 1.5, *lay3), u(0.5, 1.5, ncol, n + 1, ngl),
             u(0.8, 1.0, ncol, ngl), u(0.5, 1.5, ncol, ngl),
             u(0.0, 0.5, ncol, ngl), u(0.5, 1.5, ncol, n + 1),
             u(0.5, 1.5, ncol, n + 1))
        kw = dict(ds=1.66, weight=0.5)
        n0 = lwb.lw_noscat_bwd.launches
        if n == nlay:
            got = lwb.lw_noscat_bwd(*a, **kw)
            ref = lwb.lw_noscat_bwd_plain(*a, **kw)
            torch.cuda.synchronize()
            errs = [float((g - r).abs().max()) / float(r.abs().max())
                    for g, r in zip(got, ref)]
            log(f"solver_lw_bwd: the tallest column, {n} layers at {ngl} "
                "g-points, against the twin: "
                + ", ".join(f"{e:.3e}" for e in errs)
                + f" of the largest twin value (limit {TOL_ADJ})")
            beyond = [i for i, e in enumerate(errs) if not e <= TOL_ADJ]
            if beyond:
                with float32_constants():
                    ref64 = lwb.lw_noscat_bwd_plain(*to_f64(a), **kw)
                for i in list(beyond):
                    scale = float(ref64[i].abs().max())
                    k64 = float((got[i].double() - ref64[i]).abs().max()) \
                        / scale
                    t64 = float((ref[i].double() - ref64[i]).abs().max()) \
                        / scale
                    log(f"solver_lw_bwd: cotangent {i} against the float64 "
                        f"twin: kernel {k64:.3e}, float32 twin {t64:.3e}")
                    if t64 > TOL_ADJ and k64 <= TOL_ADJ:
                        beyond.remove(i)
            if beyond or lwb.lw_noscat_bwd.launches != n0 + 1:
                raise SystemExit("solver_lw_bwd: the tallest column "
                                 "disagrees with the twin")
            del got, ref
            continue
        try:
            lwb.lw_noscat_bwd(*a, **kw)
        except ValueError as e:
            if f"at most {nlay} layers" not in str(e):
                raise
            log(f"solver_lw_bwd: {n} layers raise ValueError: {e}")
        else:
            raise SystemExit(f"solver_lw_bwd: {n} layers did not raise")
        if lwb.lw_noscat_bwd.launches != n0:
            raise SystemExit("solver_lw_bwd: launched past its limit")
    del a, tau

    rng = np.random.default_rng(21)

    # ssa up to 0.9 and g up to 0.8 put the two-stream k in [0.55, 2]; mu0
    # in [0.2, 0.3] keeps k mu0 below 0.6, away from the clamp at k mu0 =
    # 1, near which float32 resolves the adjoint's ssa, g and mu0
    # cotangents in no implementation (test_sw_solver_adjoint_low_suns)
    def args(nlay, mu_lo=0.2, mu_hi=0.3):
        bc = (ncol, ngpt)
        inc = u(0.5, 2.0, *bc)
        return (u(0.0, 0.1, ncol, nlay, ngpt), u(0.0, 0.9, ncol, nlay, ngpt),
                u(0.0, 0.8, ncol, nlay, ngpt), u(mu_lo, mu_hi, ncol, nlay),
                u(0.0, 0.3, *bc), u(0.0, 0.3, *bc), inc, 0.05 * inc)

    for kernel, fn, plain, tol, cots in (
            ("solver_sw", ss.sw_2stream, ss.sw_2stream_plain, TOL_FLUX, 0),
            ("solver_sw_bwd", ssw.sw_2stream_bwd, ssw.sw_2stream_bwd_plain,
             TOL_ADJ, 3)):
        nlay = tallest_column(kernel, ngpt)
        a = args(nlay) + tuple(u(0.5, 1.5, ncol, nlay + 1)
                               for _ in range(cots))
        got, ref = fn(*a), plain(*a)
        torch.cuda.synchronize()
        if cots:
            errs = [float((g - r).abs().max()) / float(r.abs().max())
                    for g, r in zip(got, ref)]
        else:
            errs = [max(float((g - r).abs().max()) for g, r in zip(got, ref))
                    / max(float(r.abs().max()) for r in ref)]
        log(f"{kernel}: the tallest column, {nlay} layers at {ngpt} "
            f"g-points, against the twin: "
            + ", ".join(f"{e:.3e}" for e in errs)
            + f" of the largest twin value (limit {tol})")
        beyond = [i for i, e in enumerate(errs) if not e <= tol]
        if beyond and cots:
            with float32_constants():
                ref64 = plain(*to_f64(a))
            for i in list(beyond):
                scale = float(ref64[i].abs().max())
                k64 = float((got[i].double() - ref64[i]).abs().max()) / scale
                t64 = float((ref[i].double() - ref64[i]).abs().max()) / scale
                log(f"{kernel}: cotangent {i} against the float64 twin: "
                    f"kernel {k64:.3e}, float32 twin {t64:.3e}")
                if t64 > tol and k64 <= tol:
                    beyond.remove(i)
        if beyond:
            raise SystemExit(f"{kernel}: the tallest column disagrees with "
                             "the twin")
        a = args(nlay + 1) + tuple(u(0.5, 1.5, ncol, nlay + 2)
                                   for _ in range(cots))
        n0 = fn.launches
        try:
            fn(*a)
        except ValueError as e:
            if f"at most {nlay} layers" not in str(e):
                raise
            log(f"{kernel}: {nlay + 1} layers raise ValueError: {e}")
        else:
            raise SystemExit(f"{kernel}: {nlay + 1} layers did not raise")
        if fn.launches != n0:
            raise SystemExit(f"{kernel}: launched past its limit")

    # row 15 again with mu0 in [0.3, 0.9], k mu0 up to the clamp: each
    # cotangent within TOL_ADJ of its largest twin value or, where the
    # float32 twin misses TOL_ADJ against the float64 twin, within
    # TOL_COND times the twin's distance from it (the low-suns rule)
    nlay = tallest_column("solver_sw_bwd", ngpt)
    a = args(nlay, 0.3, 0.9) + tuple(u(0.5, 1.5, ncol, nlay + 1)
                                     for _ in range(3))
    got, ref = ssw.sw_2stream_bwd(*a), ssw.sw_2stream_bwd_plain(*a)
    with float32_constants():
        ref64 = ssw.sw_2stream_bwd_plain(*to_f64(a))
    for i, (g, r, r64) in enumerate(zip(got, ref, ref64)):
        err = float((g - r).abs().max()) / float(r.abs().max())
        scale = float(r64.abs().max())
        k64 = float((g.double() - r64).abs().max()) / scale
        t64 = float((r.double() - r64).abs().max()) / scale
        log(f"solver_sw_bwd: the tallest column, mu0 in [0.3, 0.9], "
            f"cotangent {i}: {err:.3e} of the largest twin value; from the "
            f"float64 twin kernel {k64:.3e}, float32 twin {t64:.3e}")
        if not (err <= TOL_ADJ or (t64 > TOL_ADJ and k64 <= TOL_COND * t64)):
            raise SystemExit(f"solver_sw_bwd: the tallest column near the "
                             f"clamp, cotangent {i} disagrees with the twin")
    del got, ref, ref64


def peak_memory(name, fn):
    """Peak device memory of one call of fn beyond what is held before."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"{name}: peak device memory {peak} B ({peak / 1e9:.3f} GB; "
        f"{(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB held "
        "before the step)")


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
    runs, launches = counted(
        f"{name} training step", counters,
        lambda: [train_loss(step, inputs) for _ in range(2)], exact,
        launched, per=2)
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
    t_train = wall_ms(lambda: train_loss(step, inputs))
    t_fwd = wall_ms(lambda: step(inputs))
    log(f"{name} training step: {t_train:.3f} ms median of {REPS} "
        f"(forward alone {t_fwd:.3f} ms)")
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


def run_path(name, step, inputs, counters, must, solar, once=(),
             nonneg=True, exact=None):
    """Drive one path with the counters set to 0 just before it; check
    the launches (each in ``must`` at least once, those in ``once``
    exactly once, those in ``exact`` (name -> launches) so many times, no
    other), finite (and with ``nonneg`` non-negative) outputs and, with
    ``solar``, TOA SW; time it. Returns (outputs, launches)."""
    import torch
    out, launches = counted(f"{name} path", counters, lambda: step(inputs),
                            dict({k: 1 for k in once}, **(exact or {})),
                            must)
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
    t_step = wall_ms(lambda: step(inputs))
    log(f"{name} path step: {t_step:.3f} ms median of {REPS}, "
        f"{ncol / t_step * 1e3:.1f} columns/s")
    return out, launches


# the hand-written kernels (csrc/*.cu), which profile_path names whatever
# their rank
HAND_KERNELS = ("cloud_props_kernel", "fused_lw_kernel", "fused_sw_kernel",
                "gas_major_kernel", "gas_minor_kernel", "gas_rayleigh_kernel",
                "solver_lw_kernel", "solver_lw_2str_kernel",
                "solver_sw_kernel", "fused_lw_bwd_kernel",
                "fused_sw_bwd_kernel", "solver_lw_bwd_kernel",
                "solver_sw_bwd_kernel", "minor_scale_kernel",
                "minor_scale_bwd_kernel", "gas_descriptors_kernel",
                "gas_descriptors_bwd_kernel")


def profile_path(name, step, inputs, n=3, top=8):
    """Device time by kernel and the device's busy share over n steps,
    from torch.profiler (the profiler's own overhead lengthens the wall
    time, so the busy share is a lower bound): the ``top`` kernels by
    time, then every other hand-written kernel, each on its own line."""
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
    hand = lambda key: any(k + "<" in key or k + "(" in key
                           for k in HAND_KERNELS)
    shown = rows[:top] + [r for r in rows[top:] if hand(r[2])]
    for ms, count, key in shown:
        log(f"profile {name}:   {ms:8.3f} ms  x{count:g}  {key[:70]}")
    rest = [r for r in rows[top:] if not hand(r[2])]
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
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_descriptors import (
        gas_descriptors, gas_descriptors_bwd)
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_major import gas_major
    from rte_rrtmgp_tpu_torch.ops.kernels.gas_minor import (gas_minor,
                                                            gas_rayleigh)
    from rte_rrtmgp_tpu_torch.ops.kernels.minor_scale import (
        minor_scale, minor_scale_bwd)
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
    rows = (fused_rows(prob, dev, variants) + scale_rows(prob, variants)
            + descriptor_rows(prob, variants)
            + api_rows(prob, dev, variants)
            + lw2_rows(prob, dev, variants) + lanes_rows(prob, nonbanded))
    torch.cuda.empty_cache()
    rows += adjoint_rows(prob, dev, variants)
    adjoint_report(prob, reports)
    onchip_report(prob, reports)
    onchip_limits(dev)
    t0 = time.perf_counter()
    rf = rfmip_problem(dev)
    rfmip_rows(rf, dev, variants)
    added = {"phase 3": time.perf_counter() - t0}
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
    t0 = time.perf_counter()
    rfmip_gate(dev)
    added["phase 4"] = time.perf_counter() - t0
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
                "solver_sw_bwd": sw_2stream_bwd,
                "minor_scale": minor_scale,
                "minor_scale_bwd": minor_scale_bwd,
                "gas_descriptors": gas_descriptors,
                "gas_descriptors_bwd": gas_descriptors_bwd}
    gathers = ("gas_major", "gas_minor", "gas_rayleigh")
    prep = ("minor_scale", "gas_descriptors")
    launched = {
        "fused": ("cloud_props", "fused_lw", "fused_sw") + prep,
        "public API": ("cloud_props",) + gathers + ("solver_lw",
                                                    "solver_sw") + prep,
        "staged": ("cloud_props",) + gathers + ("solver_lw_pfrac",
                                                "solver_sw_combined") + prep,
        "staged non-banded": ("cloud_props",) + gathers + (
            "solver_lw_lanes", "solver_sw_lanes") + prep,
        "two-stream": ("cloud_props", "gas_major", "gas_minor",
                       "solver_lw_2str") + prep}
    # the scaling rows and the descriptors: one launch each per gas-optics
    # call (LW and SW; the two-stream path's LW alone)
    scale_calls = {"two-stream": 1}

    def drive(name, kind, step, inputs, solar, clouds=True, once=(),
              nonneg=True):
        must = tuple(k for k in launched[kind]
                     if clouds or k != "cloud_props")
        return run_path(name, step, inputs, counters, must, solar, once,
                        nonneg, {k: scale_calls.get(kind, 2) for k in prep})

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
    peak_memory("fused step", lambda: step(inputs))
    peak_memory("two-stream step", lambda: lw2_step(prob)(inputs))

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
                  "fused_sw_bwd": 1, "cloud_props": 2, "minor_scale": 2,
                  "minor_scale_bwd": 2, "gas_descriptors": 2,
                  "gas_descriptors_bwd": 2}
    step, _ = build_allsky_step(**MAIN, device=dev)
    got = training_steps("fused", step, inputs, counters, fused_step, ())
    peak_memory("fused training step", lambda: train_loss(step, inputs))
    launches.update({k: got[k] for k in ("fused_lw_bwd", "fused_sw_bwd",
                                         "minor_scale_bwd",
                                         "gas_descriptors_bwd")})
    profile_path("fused training step", lambda i: train_loss(step, i),
                 inputs)
    step, _ = build_allsky_step(**MAIN, device=dev, use_aerosols=True)
    training_steps("aerosols fused", step, inputs, counters, fused_step, ())
    got = training_steps(
        "public API", step_fn(prob, "api"), inputs, counters,
        {"solver_lw_bwd": 1, "solver_sw_bwd": 1, "solver_lw": 1,
         "solver_sw": 1, "cloud_props": 2, "minor_scale": 2,
         "minor_scale_bwd": 2, "gas_descriptors": 2,
         "gas_descriptors_bwd": 2},
        ("gas_major", "gas_minor", "gas_rayleigh"))
    launches.update({k: got[k] for k in ("solver_lw_bwd", "solver_sw_bwd")})
    del step
    torch.cuda.empty_cache()

    # the RFMIP driver (fused and generic routes, SSM) and the pod-scale
    # stream
    t0 = time.perf_counter()
    rfmip_paths(rf, dev, counters, card)
    del rf
    podscale_paths(dev, counters, card)
    torch.cuda.empty_cache()
    added["phase 5"] = time.perf_counter() - t0
    log("RFMIP, SSM and podscale additions: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in added.items())
        + f", {sum(added.values()):.1f} s in all")

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
